"""The port's Transformer-XL LM encoder against the JAX package's and
against a naive loop: ``RelMultiHeadAttention`` against the loop of
``tests/test_transformer_xl.py`` (score[i, j] = (q_i + u).k_j +
(q_i + w).R[M + i - j], causal) and against the JAX module on converted
weights, with and without segment memory; segment memory against the
full context; padded memory masked by ``mems_valid``; the whole LM
(``TransformerXLNet``) through ``LSTMLM``'s loss, its logits, loss and
every gradient, with and without ``mems``, fp32, and its logits under
"mixed"; the full-width recipe's parameter count against the JAX
model's (``jax.eval_shape``); and the tiny recipe's train step.

Tolerance: fp32, rtol 1e-5 and atol 1e-5 on attention outputs, logits
and gradients, 1e-5 relative on the loss; the naive loop (fp64 sums in
another order, softmax over -1e9) within 1e-4; "mixed" within 3 bf16
ulps of max(1, |logit|) and a mean error of 1e-3, as the port's other
bf16 encoders are held (``test_torch_lm.py``): the two frameworks round
the bf16 products at the same places, and the tied softmax multiplies
the same bf16 values in fp32 on both sides."""
import os
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openseq2seq_tpu.encoders.transformer_xl_encoder import (
    RelMultiHeadAttention as JaxRelMHA, TransformerXLNet as JaxTXLNet)
from openseq2seq_tpu.losses import BasicSequenceLoss as JaxSequenceLoss
from openseq2seq_tpu_torch.convert import (flax_from_state_dict,
                                           layer_norm_modules,
                                           state_dict_from_flax)
from openseq2seq_tpu_torch.encoders.transformer_xl_encoder import (
    RelMultiHeadAttention, TransformerXLNet)
from openseq2seq_tpu_torch.losses import BasicSequenceLoss
from openseq2seq_tpu_torch.parts.transformer.common import rel_pos_embedding
from jax_global_state import jax_globals, jax_globals_module  # noqa: F401
from test_torch_tdnn import randomize
from test_torch_text_data import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TXL_WKT103 = os.path.join(REPO, "example_configs_torch", "lm",
                          "txl_wkt103.py")
TXL_TINY = os.path.join(REPO, "example_configs_torch", "lm", "txl_tiny.py")
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ULP = 2.0 ** -7


def _naive(attn, x, mems=None):
    """score[i, j] = ((q_i + u).k_j + (q_i + w).R[d]) / sqrt(Dh), d = M +
    i - j, keys after the query left out; fp64."""
    p = {n: v.detach().double().numpy() for n, v in attn.named_parameters()}
    B, T, D = x.shape
    ctx = x if mems is None else np.concatenate([mems, x], axis=1)
    M, K = ctx.shape[1] - T, ctx.shape[1]
    H, Dh = p["u_bias"].shape
    q = np.einsum("btd,dhe->bthe", x, p["q.kernel"])
    k = np.einsum("btd,dhe->bthe", ctx, p["k.kernel"])
    v = np.einsum("btd,dhe->bthe", ctx, p["v.kernel"])
    r = np.einsum("kd,dhe->khe", rel_pos_embedding(K, D).astype(np.float64),
                  p["r.kernel"])
    out = np.zeros((B, T, H, Dh))
    for b in range(B):
        for h in range(H):
            for i in range(T):
                js = [j for j in range(K) if M + i - j >= 0]
                s = np.array([((q[b, i, h] + p["u_bias"][h]) @ k[b, j, h] +
                               (q[b, i, h] + p["w_bias"][h]) @
                               r[M + i - j, h]) / np.sqrt(Dh) for j in js])
                w = np.exp(s - s.max())
                out[b, i, h] = (w / w.sum()) @ v[b, js, h]
    return np.einsum("bthe,hed->btd", out, p["out.kernel"])


def _attention(D=16, H=4):
    attn = RelMultiHeadAttention(D, H, 1.0, torch.float32, 32,
                                 torch.Generator().manual_seed(0))
    with torch.no_grad():
        attn.u_bias.normal_(generator=torch.Generator().manual_seed(1))
        attn.w_bias.normal_(generator=torch.Generator().manual_seed(2))
    return attn


@pytest.mark.parametrize("M", [0, 3])
def test_rel_attention_matches_naive_loop(M):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 16).astype(np.float32)
    mems = rng.randn(2, M, 16).astype(np.float32) if M else None
    attn = _attention()
    with torch.no_grad():
        got = attn(torch.from_numpy(x),
                   None if mems is None else torch.from_numpy(mems))
    np.testing.assert_allclose(got.numpy(), _naive(attn, x, mems),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("M", [0, 4])
def test_rel_attention_matches_jax(M):
    rng = np.random.RandomState(1)
    B, T, D, H = 3, 6, 16, 4
    x = rng.randn(B, T, D).astype(np.float32)
    mems = rng.randn(B, M, D).astype(np.float32) if M else None
    valid = np.ones((B, M + T), bool)
    valid[1, -2:] = False
    valid[2, :2] = False
    jattn = JaxRelMHA(num_heads=H, dropout=0.0)
    jm = None if mems is None else jnp.asarray(mems)
    variables = randomize(dict(jattn.init(jax.random.PRNGKey(0),
                                          jnp.asarray(x), mems=jm)), 3)
    variables["params"]["u_bias"] = rng.randn(H, D // H).astype(np.float32)
    variables["params"]["w_bias"] = rng.randn(H, D // H).astype(np.float32)
    want = jattn.apply(variables, jnp.asarray(x), mems=jm,
                       pad_mask=jnp.asarray(valid))
    attn = _attention(D, H)
    # the converter keeps a DenseGeneral kernel by its parent's name
    sd = state_dict_from_flax({"params": {"layer0_attn":
                                          variables["params"]}})
    attn.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    with torch.no_grad():
        got = attn(torch.from_numpy(x),
                   None if mems is None else torch.from_numpy(mems),
                   pad_mask=torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _nets(V=23, L=2, D=16, H=4, F=32, mem_len=0, dtype="float32",
          jax_dtype=jnp.float32, torch_dtype=torch.float32, T=8, seed=0):
    """The JAX and the port's nets on the same (randomized) weights."""
    jnet = JaxTXLNet(vocab_size=V, num_layers=L, hidden_size=D,
                     num_heads=H, filter_size=F, dropout=0.0,
                     attention_dropout=0.0, mem_len=mem_len,
                     dtype_=jax_dtype)
    x = jnp.zeros((2, T), jnp.int32)
    variables = randomize(dict(jnet.init(jax.random.PRNGKey(seed), x,
                                         jnp.full((2,), T), False)), seed)
    rng = np.random.RandomState(seed)
    for i in range(L):
        p = variables["params"]["layer{}_attn".format(i)]
        p["u_bias"] = rng.randn(H, D // H).astype(np.float32)
        p["w_bias"] = rng.randn(H, D // H).astype(np.float32)
    net = TransformerXLNet(V, L, D, H, F, 0.0, 0.0, mem_len, torch_dtype, 32,
                           torch.Generator().manual_seed(0))
    net.load_state_dict(state_dict_from_flax(variables))
    return jnet, variables, net


def test_convert_round_trip():
    """Every flax leaf of the net maps onto a port parameter and back:
    the DenseGeneral kernels of ``layer{i}_attn`` as they are, the bare
    layer norms ``layer{i}_ln1``/``_ln2``, the tied ``softmax_bias``."""
    _, variables, net = _nets()
    sd = net.state_dict()
    assert "layer0_attn.r.kernel" in sd and "layer1_ln2.weight" in sd
    back = flax_from_state_dict(sd, layer_norm_modules(net))

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, prefix + k + "/"))
            else:
                out[prefix + k] = np.asarray(v)
        return out
    want, got = flat(variables["params"]), flat(back["params"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_segment_memory_matches_full_context():
    """Scoring [seg1][seg2] with seg1's ``mems`` gives the logits of the
    concatenation's second half."""
    rng = np.random.RandomState(1)
    _, _, net = _nets(V=11, mem_len=8, T=16, seed=1)
    full = torch.from_numpy(rng.randint(0, 11, (2, 16)))
    with torch.no_grad():
        out_full = net(full, torch.full((2,), 16))
        out1 = net(full[:, :8], torch.full((2,), 8))
        out2 = net(full[:, 8:], torch.full((2,), 8), mems=out1["mems"])
    assert len(out1["mems"]) == 2 and out1["mems"][0].shape == (2, 8, 16)
    np.testing.assert_allclose(out2["logits"].numpy(),
                               out_full["logits"][:, 8:].numpy(), **TOL)


def test_mems_valid_masks_padded_memory():
    rng = np.random.RandomState(2)
    _, _, net = _nets(V=7, mem_len=4, T=4, seed=2)
    x = torch.from_numpy(rng.randint(0, 7, (2, 4)))
    lengths = torch.full((2,), 4)
    mems = [torch.from_numpy(rng.randn(2, 4, 16).astype(np.float32))
            for _ in range(2)]
    valid = torch.tensor([[True, True, False, False],
                          [True, True, True, False]])
    with torch.no_grad():
        out1 = net(x, lengths, mems=mems, mems_valid=valid)
        trash = [m + torch.where(valid[..., None], 0.0, 100.0) for m in mems]
        out2 = net(x, lengths, mems=trash, mems_valid=valid)
        out3 = net(x, lengths, mems=[m + 1.0 for m in mems],
                   mems_valid=valid)
    np.testing.assert_allclose(out1["logits"].numpy(),
                               out2["logits"].numpy(), atol=1e-5)
    assert not np.allclose(out1["logits"].numpy(), out3["logits"].numpy())
    assert torch.equal(out1["mems_valid"], torch.cat([valid, torch.ones(
        (2, 4), dtype=torch.bool)], 1)[:, -4:])


@pytest.mark.parametrize("M", [0, 5])
def test_lm_loss_and_gradients_match_jax(M):
    """The LM's loss (``BasicSequenceLoss`` as ``txl_wkt103.py`` sets it:
    averaged over time, no mask) and every gradient, from the same
    weights, tokens and memory."""
    rng = np.random.RandomState(4)
    V, T, B = 29, 8, 2
    jnet, variables, net = _nets(V=V, mem_len=M, T=T, seed=4)
    x = rng.randint(0, V, (B, T)).astype(np.int32)
    y = rng.randint(0, V, (B, T)).astype(np.int32)
    lengths = np.full((B,), T, np.int32)
    mems = [rng.randn(B, M, 16).astype(np.float32) for _ in range(2)] \
        if M else None
    mv = np.array([[True] * M, [False] + [True] * (M - 1)]) if M else None
    lp = {"tgt_vocab_size": V, "batch_size": B,
          "offset_target_by_one": False, "average_across_timestep": True,
          "do_mask": False}

    def jloss(p):
        out = jnet.apply({"params": p}, jnp.asarray(x), jnp.asarray(lengths),
                         False, mems=None if mems is None else
                         [jnp.asarray(m) for m in mems],
                         mems_valid=None if mv is None else jnp.asarray(mv))
        return JaxSequenceLoss(dict(lp), None).compute_loss(
            {"decoder_output": out,
             "target_tensors": [jnp.asarray(y), jnp.asarray(lengths)]}), out
    (jl, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        variables["params"])
    out = net(torch.from_numpy(x), torch.from_numpy(lengths),
              mems=None if mems is None else [torch.from_numpy(m)
                                              for m in mems],
              mems_valid=None if mv is None else torch.from_numpy(mv))
    loss = BasicSequenceLoss(dict(lp), None).compute_loss(
        {"decoder_output": out, "target_tensors": [
            torch.from_numpy(y), torch.from_numpy(lengths)]})
    loss.backward()
    np.testing.assert_allclose(out["logits"].detach().numpy(),
                               np.asarray(jout["logits"]), **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want = state_dict_from_flax({"params": jgrads})
    got = dict(net.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), **TOL,
                                   err_msg=name)
    if M:
        for a, b in zip(out["mems"], jout["mems"]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_mixed_logits_match_jax():
    """bf16 compute: the blocks round where the JAX package's round, the
    tied softmax multiplies the bf16-rounded operands in fp32."""
    rng = np.random.RandomState(5)
    jnet, variables, net = _nets(V=37, T=12, seed=5, jax_dtype=jnp.bfloat16,
                                 torch_dtype=torch.bfloat16)
    x = rng.randint(0, 37, (2, 12)).astype(np.int32)
    lengths = np.array([12, 9], np.int32)
    want = np.asarray(jnet.apply(variables, jnp.asarray(x),
                                 jnp.asarray(lengths), False)["logits"])
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(lengths))["logits"]
    assert got.dtype == torch.float32 and want.dtype == np.float32
    err = np.abs(got.numpy() - want) / np.maximum(1.0, np.abs(want))
    assert err.mean() <= 1e-3 and err.max() <= 3 * BF16_ULP, (err.mean(),
                                                              err.max())


def test_wkt103_parameter_count_matches_jax():
    """``txl_wkt103.py`` at WikiText-103's V (267,736 from
    ``fake_wikitext``'s corpus): the port's parameter count is the JAX
    net's, from ``jax.eval_shape`` of its init."""
    enc = runpy.run_path(TXL_WKT103)["base_params"]["encoder_params"]
    V = 267736
    jnet = JaxTXLNet(vocab_size=V, num_layers=enc["num_layers"],
                     hidden_size=enc["hidden_size"],
                     num_heads=enc["num_heads"],
                     filter_size=enc["filter_size"], dropout=0.1,
                     attention_dropout=0.0, mem_len=0, dtype_=jnp.bfloat16)
    shapes = jax.eval_shape(lambda: jnet.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
        jnp.full((1,), 8), False))
    want = sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(shapes))
    with torch.device("meta"):
        net = TransformerXLNet(V, enc["num_layers"], enc["hidden_size"],
                               enc["num_heads"], enc["filter_size"], 0.1,
                               0.0, 0, torch.bfloat16, 32, None)
    got = sum(p.numel() for p in net.parameters())
    assert got == want == 151119016, (got, want)


def test_tiny_recipe_train_step():
    """The tiny recipe's model takes Adam steps on the cycle corpus with
    dropout on: finite losses that fall, from one seed the same losses."""
    config = runpy.run_path(TXL_TINY)
    losses = []
    for _ in range(2):
        model = config["base_model"](dict(config["base_params"]),
                                     mode="train", device="cpu")
        dl = model.get_data_layer()
        batch = next(iter(dl.iterate_one_epoch()))
        state = model.init_state(batch)
        run = []
        for step in range(8):
            state, m = model.train_step(
                state, batch, torch.Generator().manual_seed(step))
            run.append(float(m["loss"]))
        losses.append(run)
    assert losses[0] == losses[1]
    assert all(np.isfinite(losses[0])) and losses[0][-1] < losses[0][0]
