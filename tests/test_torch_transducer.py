"""The port's transducer (RNN-T) loss, decoder and n-gram fusion tables
against the JAX package's, on the CPU in fp32, from the same numpy-seeded
inputs and the same weights (carried by ``convert.py``):

  * ``transducer_loss``: value and d logits at rtol 1e-5 (atol 1e-7 on the
    gradient's elements, 1e-6 of its largest), with rows whose labels
    outnumber their frames, a row with no label and a row of one frame;
  * ``transducer_loss_fused`` at ``block_size`` 1, 3, 8 (a trailing
    partial block) and 16 (past the last diagonal): value and gradients
    of ``enc_j``, ``pred_j`` and the joint's weights against the JAX fused
    loss at the same tolerance, and against the port's lattice loss;
  * FastEmit: the value unchanged, the gradients JAX's;
  * the decoder module's training outputs (the lattice's logits and the
    fused loss's activations) at rtol 1e-5;
  * greedy decode: ids, lengths and emission frames bit-equal, and a
    decode in two windows with the carry equal to the whole one;
  * beam decode, with and without shallow fusion from an ARPA file that
    ``build_arpa`` writes: the best ids equal, the n-best scores within
    NBEST_ATOL (fp32 sums of some 20 log-probs in another order), the
    exhaustive beam equal to the JAX package's exhaustive oracle;
  * ``dense_label_lm``'s tables within 1e-6.

The model-level tests (the tiny Conformer-Transducer's eval step and
AdamW step, ``run.main``, the conversion, the full width's parameter
count, the toy) are in ``test_torch_transducer_model.py``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from openseq2seq_tpu.decoders.transducer_decoder import (
    TransducerDecoderModule as JaxModule)
from openseq2seq_tpu.ops import arpa_lm as jax_arpa_lm
from openseq2seq_tpu.ops import ngram_fusion as jax_ngram_fusion
from openseq2seq_tpu.ops import transducer as jt
from openseq2seq_tpu_torch.convert import state_dict_from_flax
from openseq2seq_tpu_torch.decoders.transducer_decoder import (
    TransducerDecoderModule)
from openseq2seq_tpu_torch.ops import arpa_lm, ngram_fusion
from openseq2seq_tpu_torch.ops import transducer as pt
from test_torch_text_data import one_thread  # noqa: F401
from test_transducer import _np_beam_exhaustive_oracle

RTOL = 1e-5
NBEST_ATOL = 1e-4


def _close(got, want, what=""):
    """rtol 1e-5, atol 1e-6 of the largest |want| (at least 1e-7)."""
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    want = np.asarray(want)
    atol = max(1e-7, 1e-6 * float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL, atol=atol,
                               err_msg=what)


# --------------------------------------------------------------- the loss
# (B, T, U, V, logit lengths, label lengths): rows with U > T, no label
# and one frame; then labels twice the frames
LOSS_CASES = {
    "edges": (4, 7, 5, 6, [7, 5, 1, 6], [5, 3, 2, 0]),
    "u_over_t": (2, 3, 8, 5, [3, 2], [8, 6]),
}


def _loss_inputs(name, seed=0):
    B, T, U, V, ll, ul = LOSS_CASES[name]
    rng = np.random.RandomState(seed)
    logits = (rng.randn(B, T, U + 1, V) * 2.0).astype(np.float32)
    labels = rng.randint(0, V - 1, (B, U)).astype(np.int32)
    return logits, np.array(ll, np.int32), labels, np.array(ul, np.int32)


@pytest.mark.parametrize("lam", [0.0, 0.7])
@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_loss_matches_jax(name, lam):
    logits, ll, labels, ul = _loss_inputs(name)
    for mean in (True, False):
        def f(x):
            return jnp.sum(jt.transducer_loss(
                x, jnp.asarray(ll), jnp.asarray(labels), jnp.asarray(ul),
                average_across_batch=mean, fastemit_lambda=lam))
        want, want_g = jax.value_and_grad(f)(jnp.asarray(logits))
        x = torch.tensor(logits, requires_grad=True)
        got = pt.transducer_loss(x, torch.tensor(ll), torch.tensor(labels),
                                 torch.tensor(ul), average_across_batch=mean,
                                 fastemit_lambda=lam)
        got.sum().backward()
        _close(got.detach().sum(), want)
        assert torch.isfinite(x.grad).all()
        _close(x.grad, want_g)
    if lam:
        # FastEmit leaves the value as it was
        plain = pt.transducer_loss(torch.tensor(logits), torch.tensor(ll),
                                   torch.tensor(labels), torch.tensor(ul))
        assert float(plain) == float(got.detach().mean())


def _fused_inputs(seed=4):
    rng = np.random.RandomState(seed)
    B, T, U, J, V = 3, 6, 4, 5, 7
    weights = (rng.randn(B, T, J).astype(np.float32),
               rng.randn(B, U + 1, J).astype(np.float32),
               (rng.randn(J) * 0.1).astype(np.float32),
               rng.randn(J, V).astype(np.float32),
               (rng.randn(V) * 0.1).astype(np.float32))
    labels = rng.randint(0, V - 1, (B, U)).astype(np.int32)
    return weights, (np.array([6, 4, 2], np.int32), labels,
                     np.array([4, 2, 3], np.int32))


def _port_fused_grads(weights, args, fused, **kw):
    ts = [torch.tensor(w, requires_grad=True) for w in weights]
    targs = [torch.tensor(a) for a in args]
    if fused:
        loss = pt.transducer_loss_fused(*ts, *targs, **kw)
    else:
        enc_j, pred_j, jb, ow, ob = ts
        h = torch.tanh(enc_j[:, :, None] + pred_j[:, None] + jb)
        loss = pt.transducer_loss(h @ ow + ob, *targs, **kw)
    loss.backward()
    return float(loss.detach()), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("lam", [0.0, 0.3])
@pytest.mark.parametrize("block_size", [1, 3, 8, 16])
def test_fused_loss_matches_jax(block_size, lam):
    """D - 1 = 9 diagonals: blocks of 1 and 3 divide them, 8 leaves a
    partial block, 16 passes them all."""
    weights, args = _fused_inputs()

    def f(*w):
        return jt.transducer_loss_fused(
            *w, *(jnp.asarray(a) for a in args), block_size=block_size,
            fastemit_lambda=lam)
    want, want_g = jax.value_and_grad(f, argnums=tuple(range(5)))(
        *(jnp.asarray(w) for w in weights))
    got, got_g = _port_fused_grads(weights, args, True,
                                   block_size=block_size, fastemit_lambda=lam)
    _close(got, want)
    for name, g, w in zip(("enc_j", "pred_j", "joint_b", "out_w", "out_b"),
                          got_g, want_g):
        _close(g, w, name)
    lattice, lattice_g = _port_fused_grads(weights, args, False,
                                           fastemit_lambda=lam)
    _close(got, lattice)
    for g, w in zip(got_g, lattice_g):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


def test_fused_loss_one_frame_and_no_label():
    """T 1 and U 0: no diagonal to run; the loss is the final blank."""
    rng = np.random.RandomState(6)
    weights = (rng.randn(2, 1, 4).astype(np.float32),
               rng.randn(2, 1, 4).astype(np.float32),
               np.zeros(4, np.float32), rng.randn(4, 3).astype(np.float32),
               np.zeros(3, np.float32))
    args = (np.array([1, 1], np.int32), np.zeros((2, 0), np.int32),
            np.array([0, 0], np.int32))
    want = jt.transducer_loss_fused(*(jnp.asarray(a) for a in weights + args))
    got, grads = _port_fused_grads(weights, args, True)
    _close(got, want)
    assert all(np.isfinite(g).all() for g in grads)


# ------------------------------------------------------------- the decoder
def _jax_module(V=6, E=8, H=8, layers=2, J=8, msf=3, Lmax=0, K=1,
                fused=False, lm_fusion=None, mode="infer"):
    return JaxModule(tgt_vocab_size=V, pred_embed_size=E, pred_units=H,
                     pred_layers=layers, joint_dim=J,
                     max_symbols_per_frame=msf, max_output_length=Lmax,
                     dropout=0.0, fused_loss=fused, beam_width=K,
                     dtype_=jnp.float32, mode=mode, lm_fusion=lm_fusion)


def _pair(enc, enc_len, seed, labels=None, mode="infer", **kw):
    """(JAX module, its params, the port's module on those params)."""
    module = _jax_module(mode=mode, **kw)
    inputs = _inputs(enc, enc_len, labels, jax_side=True)
    params = jax.device_get(module.init(jax.random.PRNGKey(seed), inputs,
                                        False)["params"])
    lm = module.lm_fusion
    port = TransducerDecoderModule(
        vocab=module.tgt_vocab_size, embed=module.pred_embed_size,
        units=module.pred_units, layers=module.pred_layers,
        joint=module.joint_dim, enc_width=enc.shape[-1],
        max_symbols_per_frame=module.max_symbols_per_frame,
        max_output_length=module.max_output_length, keep_prob=1.0,
        dropout_bits=32, fused_loss=module.fused_loss,
        beam_width=module.beam_width, dtype=torch.float32, mode=mode,
        lm_fusion=lm, generator=torch.Generator().manual_seed(0))
    port.load_state_dict(state_dict_from_flax({"params": params}))
    return module, params, port


def _inputs(enc, enc_len, labels=None, jax_side=False, **extra):
    conv = jnp.asarray if jax_side else torch.tensor
    out = {"encoder_output": {"outputs": conv(enc),
                              "src_length": conv(enc_len)}}
    if labels is not None:
        out["target_tensors"] = [conv(labels[0]), conv(labels[1])]
    out.update(extra)
    return out


def _run_both(module, params, port, enc, enc_len, labels=None, train=False,
              jax_extra=None, port_extra=None):
    want = jax.device_get(module.apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, params)},
        _inputs(enc, enc_len, labels, True, **(jax_extra or {})), train))
    with torch.no_grad():
        got = port(_inputs(enc, enc_len, labels, **(port_extra or {})),
                   train)
    return got, want


def _enc(B, T, D, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, T, D) * scale).astype(np.float32)


@pytest.mark.parametrize("fused", [False, True])
def test_training_outputs_match_jax(fused):
    B, T, D, U, V = 3, 7, 10, 4, 6
    enc = _enc(B, T, D, 1)
    rng = np.random.RandomState(2)
    labels = (rng.randint(0, V - 1, (B, U)).astype(np.int32),
              np.array([4, 2, 0], np.int32))
    enc_len = np.array([7, 5, 2], np.int32)
    module, params, port = _pair(enc, enc_len, 3, labels, mode="train",
                                 V=V, fused=fused)
    got, want = _run_both(module, params, port, enc, enc_len, labels,
                          train=True)
    if fused:
        for key in ("enc_j", "pred_j", "joint_b", "out_w", "out_b"):
            _close(got["joint_fused"][key], want["joint_fused"][key], key)
        assert "logits" not in got
    else:
        assert got["logits"].shape == (B, T, U + 1, V)
        _close(got["logits"], want["logits"])
        assert "joint_fused" not in got
    assert "outputs" not in got


def test_greedy_decode_matches_jax():
    B, T, D = 3, 12, 10
    enc = _enc(B, T, D, 3)
    enc_len = np.array([12, 7, 1], np.int32)
    module, params, port = _pair(enc, enc_len, 0)
    got, want = _run_both(module, params, port, enc, enc_len)
    for g, w in zip(got["outputs"], want["outputs"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got["emit_frames"].numpy(),
                                  want["emit_frames"])
    assert int(got["outputs"][1].sum()) > 0
    assert int(got["outputs"][1][2]) <= 3   # one frame: msf labels at most


def test_greedy_decode_in_windows_equals_whole():
    """Two windows with the carry threaded through emit the whole
    utterance's labels, the JAX package's too."""
    B, T, D = 2, 12, 10
    enc = _enc(B, T, D, 5)
    enc_len = np.array([12, 7], np.int32)
    module, params, port = _pair(enc, enc_len, 0, Lmax=3 * T)
    whole, jwhole = _run_both(module, params, port, enc, enc_len)
    np.testing.assert_array_equal(whole["outputs"][0].numpy(),
                                  jwhole["outputs"][0])
    w1 = (np.zeros(B, np.int32), np.full(B, 6, np.int32))
    w2 = (np.full(B, 6, np.int32), np.full(B, T, np.int32))
    o1, j1 = _run_both(module, params, port, enc, enc_len,
                       jax_extra={"decode_window": w1},
                       port_extra={"decode_window": w1})
    o2, j2 = _run_both(module, params, port, enc, enc_len,
                       jax_extra={"decode_window": w2,
                                  "decode_carry": j1["decode_carry"]},
                       port_extra={"decode_window": w2,
                                   "decode_carry": o1["decode_carry"]})
    for b in range(B):
        n1, n2 = int(o1["outputs"][1][b]), int(o2["outputs"][1][b])
        cat = np.concatenate([o1["outputs"][0][b, :n1].numpy(),
                              o2["outputs"][0][b, :n2].numpy()])
        n = int(whole["outputs"][1][b])
        assert n1 + n2 == n and n1 > 0 and n2 > 0
        np.testing.assert_array_equal(cat, whole["outputs"][0][b, :n].numpy())
    for g, w in ((o1, j1), (o2, j2)):
        np.testing.assert_array_equal(g["outputs"][0].numpy(),
                                      w["outputs"][0])


def _assert_beams_match(got, want, K):
    np.testing.assert_array_equal(got["outputs"][1].numpy(),
                                  want["outputs"][1])
    np.testing.assert_array_equal(got["outputs"][0].numpy(),
                                  want["outputs"][0])
    ids, lens, scores = (x.numpy() for x in got["nbest"])
    jids, jlens, jscores = (np.asarray(x) for x in want["nbest"])
    assert ids.shape == jids.shape and scores.shape == jscores.shape
    np.testing.assert_allclose(scores, jscores, rtol=0, atol=NBEST_ATOL)
    # the live lanes' hypotheses are the JAX beam's
    live = jscores > -1e29
    np.testing.assert_array_equal(lens[live], jlens[live])
    np.testing.assert_array_equal(ids[live], jids[live])
    assert np.all(np.diff(scores, axis=1) <= 0)
    np.testing.assert_array_equal(ids[:, 0], got["outputs"][0].numpy())
    assert live[:, :min(K, 2)].all()


def _fusion_lm(tmp_path, labels, order=3):
    """A toy label LM through the port's ``build_arpa``."""
    sents = [[labels[i % len(labels)] for i in range(s, s + 4)]
             for s in range(6)]
    sents += [list("abc"), list("bca"), list("cab")]
    path = str(tmp_path / "fusion.arpa")
    arpa_lm.build_arpa(sents, path, order=order)
    return path


@pytest.mark.parametrize("fusion", [False, True])
def test_beam_decode_matches_jax(fusion, tmp_path):
    B, T, D, V, K = 3, 6, 6, 4, 4
    enc = _enc(B, T, D, 13, scale=1.5)
    enc_len = np.array([6, 2, 4], np.int32)
    lm = None
    if fusion:
        lm = (_fusion_lm(tmp_path, ["a", "b", "c"]), ("a", "b", "c"), 0.7,
              0.3, 3)
    module, params, port = _pair(enc, enc_len, 1, V=V, E=6, H=6, layers=1,
                                 J=6, msf=2, Lmax=8, K=K, lm_fusion=lm)
    got, want = _run_both(module, params, port, enc, enc_len)
    _assert_beams_match(got, want, K)


@pytest.mark.parametrize("fusion", [False, True])
def test_exhaustive_beam_matches_jax(fusion, tmp_path):
    """K 192 covers every expansion-limited alignment of 2 frames (13 a
    frame): the beam is the exhaustive search, in both packages."""
    B, T, D, V, K = 2, 2, 6, 4, 192
    enc = _enc(B, T, D, 7, scale=1.5)
    enc_len = np.array([2, 1], np.int32)
    lm = None
    if fusion:
        lm = (_fusion_lm(tmp_path, ["a", "b", "c"]), ("a", "b", "c"), 0.7,
              0.3, 3)
    module, params, port = _pair(enc, enc_len, 1, V=V, E=6, H=6, layers=1,
                                 J=6, msf=2, Lmax=8, K=K, lm_fusion=lm)
    got, want = _run_both(module, params, port, enc, enc_len)
    _assert_beams_match(got, want, K)
    fusion_spec = None
    if fusion:
        table, C, m, ctx0 = ngram_fusion.dense_label_lm(lm[0], lm[1], 3)
        fusion_spec = (table * lm[2] + lm[3], C, m, ctx0)
    ids, lens = _np_beam_exhaustive_oracle(params, enc, enc_len, V - 1, 2, 8,
                                           layers=1, fusion=fusion_spec)
    np.testing.assert_array_equal(got["outputs"][1].numpy(), lens)
    np.testing.assert_array_equal(got["outputs"][0].numpy(), ids)


# ----------------------------------------------------------- the n-gram LM
@pytest.mark.parametrize("order", [2, 3, 4])
def test_dense_label_lm_matches_jax(order, tmp_path):
    labels = ("a", "b", " ")
    path = str(tmp_path / "sp.arpa")
    ngram_fusion.build_label_lm(["ab ab ab", "ba ba", "ab ba", "a b"], path,
                                order=3)
    jpath = str(tmp_path / "sp_jax.arpa")
    jax_ngram_fusion.build_label_lm(["ab ab ab", "ba ba", "ab ba", "a b"],
                                    jpath, order=3)
    assert open(path).read() == open(jpath).read()
    table, C, m, ctx0 = ngram_fusion.dense_label_lm(path, labels, order)
    jtable, jC, jm, jctx0 = jax_ngram_fusion.dense_label_lm(path, labels,
                                                            order)
    assert (C, m, ctx0) == (jC, jm, jctx0)
    assert np.all(np.isfinite(table))
    np.testing.assert_allclose(table, jtable, rtol=0, atol=1e-6)
    for seq in ([0], [0, 1, 2], [2, 2, 0, 1, 0, 2]):
        assert ngram_fusion.sequence_fusion_score(table, C, m, ctx0, seq) \
            == pytest.approx(jax_ngram_fusion.sequence_fusion_score(
                jtable, jC, jm, jctx0, seq), abs=1e-6)
    lm, jlm = arpa_lm.ArpaLM(path), jax_arpa_lm.ArpaLM(path)
    words = ["a", "b", "<sp>", "a"]
    assert lm.sentence_log10(words) == jlm.sentence_log10(words)
