"""The port's LM cells against the JAX package's, on converted weights and
seeded numpy inputs: ``SLSTM``, ``FLSTM`` (with and without
``num_proj``), ``LayerNormLSTM`` (keep 1.0) and ``GLSTM`` (on the scan,
and in the port also through the fused LSTM recurrence, whose plain
version runs on the CPU), each with its outputs, final states and every
gradient; the layer-norm LSTM's DropConnect mask (its keep rate, one mask
a call, determinism under the generator); and ``LMEncoder``'s cell
selection on the reference names of ``tests/test_exotic_cells.py``, the
whole encoder against the JAX one.

Tolerance: fp32, rtol 1e-5 and atol 1e-5 on outputs, states and
gradients (products of at most 40 terms, summed in another order, and
carried over T = 12 steps), 1e-5 relative on the encoders' logits."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openseq2seq_tpu.encoders import LMEncoder as JaxLMEncoder
from openseq2seq_tpu.parts.rnns import rnn as jrnn
from openseq2seq_tpu_torch.convert import (flax_from_state_dict,
                                           state_dict_from_flax)
from openseq2seq_tpu_torch.encoders import LMEncoder
from openseq2seq_tpu_torch.ops import lstm_scan
from openseq2seq_tpu_torch.parts.rnns import rnn
from jax_global_state import jax_globals, jax_globals_module  # noqa: F401
from test_torch_tdnn import randomize
from test_torch_text_data import one_thread  # noqa: F401

B, T, D, H = 4, 12, 16, 24
LENGTHS = np.array([12, 9, 1, 5], np.int32)
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, width=D, out=H):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, width).astype(np.float32),
            rng.randn(B, T, out).astype(np.float32),
            rng.randn(B, out).astype(np.float32),
            rng.randn(B, out).astype(np.float32))


def _flat_state(st):
    """(h, c), or the concatenated groups' states of a GLSTM."""
    if isinstance(st, list):
        return (jnp.concatenate([s[0] for s in st], -1),
                jnp.concatenate([s[1] for s in st], -1))
    return st


def _jax_run(module, variables, x, cts, **kw):
    """Outputs, states and the gradients of sum(out ct + h ct_h + c ct_c)
    with respect to the params and x."""
    lengths = jnp.asarray(LENGTHS)
    c_out, c_h, c_c = (jnp.asarray(a) for a in cts)

    def f(params, x):
        out, st = module.apply({"params": params}, x, lengths, **kw)
        h, c = _flat_state(st)
        loss = jnp.sum(out * c_out) + jnp.sum(h * c_h)
        if c.shape == c_c.shape:
            loss = loss + jnp.sum(c * c_c)
        return loss, (out, h, c)
    (_, aux), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    return [np.asarray(a) for a in aux], grads


def _torch_run(cell, x, cts, **kw):
    xt = torch.from_numpy(x).requires_grad_()
    out, st = cell(xt, torch.from_numpy(LENGTHS), **kw)
    if isinstance(st, list):
        st = (torch.cat([s[0] for s in st], -1),
              torch.cat([s[1] for s in st], -1))
    h, c = st
    c_out, c_h, c_c = (torch.from_numpy(a) for a in cts)
    loss = (out * c_out).sum() + (h * c_h).sum()
    if c.shape == c_c.shape:
        loss = loss + (c * c_c).sum()
    loss.backward()
    return [a.detach().numpy() for a in (out, h, c)], xt.grad.numpy()


def _check(jax_cell, cell, variables, x, cts, jkw=None, tkw=None):
    cell.load_state_dict(state_dict_from_flax(variables))
    (jout, jh, jc), (jgrads, jdx) = _jax_run(jax_cell, variables, x, cts,
                                             **(jkw or {}))
    (out, h, c), dx = _torch_run(cell, x, cts, **(tkw or {}))
    assert out.shape == jout.shape
    for got, want in ((out, jout), (h, jh), (c, jc), (dx, np.asarray(jdx))):
        np.testing.assert_allclose(got, want, **TOL)
    assert np.all(out[LENGTHS == 1][:, 1:] == 0)
    want = state_dict_from_flax({"params": jgrads})
    got = {n: p.grad for n, p in cell.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), **TOL,
                                   err_msg=name)


def _init(jax_cell, x, seed, **kw):
    variables = jax_cell.init({"params": jax.random.PRNGKey(seed),
                               "dropout": jax.random.PRNGKey(1)},
                              jnp.asarray(x), jnp.asarray(LENGTHS), **kw)
    return randomize(dict(variables), seed)


def test_slstm_matches_jax():
    x, *cts = _inputs(0)
    jcell = jrnn.SLSTM(H)
    variables = _init(jcell, x, 0)
    cell = rnn.SLSTM(D, H, generator=torch.Generator().manual_seed(0))
    assert not any("recurrent" in n for n, _ in cell.named_parameters())
    _check(jcell, cell, variables, x, cts)


@pytest.mark.parametrize("num_proj", [0, 10])
def test_flstm_matches_jax(num_proj):
    out = num_proj or H
    x, c_out, c_h, _ = _inputs(1, out=out)
    c_c = np.random.RandomState(2).randn(B, H).astype(np.float32)
    jcell = jrnn.FLSTM(H, fact_size=8, num_proj=num_proj)
    variables = _init(jcell, x, 1)
    cell = rnn.FLSTM(D, H, 8, num_proj,
                     generator=torch.Generator().manual_seed(0))
    _check(jcell, cell, variables, x, (c_out, c_h, c_c))


def test_layernorm_lstm_matches_jax():
    """keep 1.0 (DropConnect off), in training and out of it."""
    x, *cts = _inputs(3)
    jcell = jrnn.LayerNormLSTM(H, recurrent_weight_keep_prob=1.0,
                               train=True)
    variables = _init(jcell, x, 3)
    rng = np.random.RandomState(4)
    p = variables["params"]
    p["ln_scale"] = rng.uniform(0.5, 1.5, (4, H)).astype(np.float32)
    p["ln_bias"] = (0.1 * rng.randn(4, H)).astype(np.float32)
    cell = rnn.LayerNormLSTM(D, H, generator=torch.Generator().manual_seed(0))
    _check(jcell, cell, variables, x, cts,
           jkw={"rngs": {"dropout": jax.random.PRNGKey(5)}},
           tkw={"train": True, "generator": torch.Generator()})


@pytest.mark.parametrize("fused", [False, True])
def test_glstm_matches_jax(fused):
    """Two groups of 64 units over a 128-wide input; with ``fused`` each
    group takes the fused LSTM recurrence (kernel B3 on the card, its
    plain version here, no launch)."""
    G, W, HG = 2, 128, 128
    rng = np.random.RandomState(6)
    x = rng.randn(B, T, W).astype(np.float32)
    cts = (rng.randn(B, T, HG).astype(np.float32),
           rng.randn(B, HG).astype(np.float32),
           rng.randn(B, HG).astype(np.float32))
    jcell = jrnn.GLSTM(HG, num_groups=G)
    variables = _init(jcell, x, 6)
    cell = rnn.GLSTM(W, HG, num_groups=G, fused=fused,
                     generator=torch.Generator().manual_seed(0))
    assert [n for n, _ in cell.named_children()] == ["group1", "group2"]
    assert lstm_scan.supported(B, T, HG // G, torch.float32)
    launches = lstm_scan.LAUNCHES
    _check(jcell, cell, variables, x, cts)
    assert lstm_scan.LAUNCHES == launches


def test_layernorm_lstm_dropconnect_mask():
    """One Bernoulli(keep) mask on W_h a call, the kept weights scaled by
    1 / keep, the same under the same generator seed, another under
    another; its keep rate within 4 standard deviations of keep."""
    keep = 0.7
    cell = rnn.LayerNormLSTM(D, 128, recurrent_weight_keep_prob=keep,
                             generator=torch.Generator().manual_seed(0))
    w = cell.recurrent_kernel.detach()
    w1 = cell.recurrent_weight(True, torch.Generator().manual_seed(3))
    w2 = cell.recurrent_weight(True, torch.Generator().manual_seed(3))
    w3 = cell.recurrent_weight(True, torch.Generator().manual_seed(4))
    assert torch.equal(w1, w2) and not torch.equal(w1, w3)
    kept = w1 != 0
    torch.testing.assert_close(w1[kept], w[kept] / keep, rtol=0, atol=0)
    n = w.numel()
    rate = kept.float().mean().item()
    assert abs(rate - keep) < 4 * np.sqrt(keep * (1 - keep) / n), rate
    assert torch.equal(cell.recurrent_weight(False), w)
    x = torch.from_numpy(_inputs(7)[0])
    lengths = torch.from_numpy(LENGTHS)
    o1, _ = cell(x, lengths, train=True,
                 generator=torch.Generator().manual_seed(9))
    o2, _ = cell(x, lengths, train=True,
                 generator=torch.Generator().manual_seed(9))
    o3, _ = cell(x, lengths, train=True,
                 generator=torch.Generator().manual_seed(10))
    assert torch.equal(o1, o2) and not torch.allclose(o1, o3)
    with pytest.raises(ValueError, match="Generator"):
        cell(x, lengths, train=True)


@pytest.mark.parametrize("core_cell,kind,cls", [
    ("BasicSLSTMCell", "slstm", rnn.SLSTM),
    ("FLSTMCell", "flstm", rnn.FLSTM),
    ("WeightDropLayerNormBasicLSTMCell", "layernorm_lstm",
     rnn.LayerNormLSTM)])
def test_lm_encoder_core_cell_selection(core_cell, kind, cls):
    """The reference's cell names select the same cell as in the JAX
    package; the two encoders' logits and outputs agree (eval, fp32)."""
    V = 50
    params = {"vocab_size": V, "emb_size": 8, "encoder_layers": 2,
              "encoder_use_skip_connections": False, "core_cell": core_cell,
              "core_cell_params": {"num_units": 8, "fact_size": 4},
              "end_token": 1, "batch_size": B, "use_cudnn_rnn": False,
              "cudnn_rnn_type": None, "weight_tied": False,
              "recurrent_weight_keep_prob": 0.9, "dtype": "float32"}
    enc = LMEncoder(dict(params), None, mode="eval")
    assert enc.cell_type() == kind
    module = enc.make_module(0, torch.Generator().manual_seed(0))
    assert type(module.net.rnn1) is cls and type(module.net.rnn2) is cls
    jenc = JaxLMEncoder(dict(params), model=None, mode="eval").make_module()
    ids = np.random.RandomState(8).randint(0, V, (B, T)).astype(np.int32)
    inputs = {"source_tensors": [jnp.asarray(ids), jnp.asarray(LENGTHS)]}
    variables = randomize(dict(jenc.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        inputs, train=False)), seed=2)
    module.load_state_dict(state_dict_from_flax(variables))
    want = jenc.apply(variables, inputs, train=False)
    with torch.no_grad():
        got = module({"source_tensors": [torch.from_numpy(ids),
                                         torch.from_numpy(LENGTHS)]}, False)
    np.testing.assert_allclose(got["outputs"].numpy(),
                               np.asarray(want["outputs"]), **TOL)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), **TOL)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("core_cell,extra", [
    ("BasicSLSTMCell", {}),
    ("FLSTMCell", {"core_cell_params": {"num_units": 8, "fact_size": 4,
                                        "num_proj": 6}}),
    ("WeightDropLayerNormBasicLSTMCell", {}),
    (None, {"lm_mode": False, "use_cell_state": True, "fc_dim": 5,
            "num_classes": 3})])
def test_convert_round_trip(core_cell, extra):
    """The flax tree of each new cell's encoder (and of the
    classification head) maps onto the port's parameters by name, and
    ``flax_from_state_dict`` gives the same tree back."""
    V = 30
    params = dict({"vocab_size": V, "emb_size": 8, "encoder_layers": 2,
                   "encoder_use_skip_connections": False,
                   "core_cell": core_cell,
                   "core_cell_params": {"num_units": 8, "fact_size": 4},
                   "end_token": 1, "batch_size": B, "use_cudnn_rnn": False,
                   "cudnn_rnn_type": None, "weight_tied": False,
                   "dtype": "float32"}, **extra)
    jenc = JaxLMEncoder(dict(params), model=None, mode="eval").make_module()
    ids = jnp.zeros((B, T), jnp.int32)
    variables = randomize(dict(jenc.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        {"source_tensors": [ids, jnp.asarray(LENGTHS)]}, train=False)), 3)
    module = LMEncoder(dict(params), None, mode="eval").make_module(
        0, torch.Generator().manual_seed(0))
    module.load_state_dict(state_dict_from_flax(variables))
    back = _flat(flax_from_state_dict(module.state_dict())["params"])
    want = _flat(variables["params"])
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
