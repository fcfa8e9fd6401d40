"""The port's CTC beam decoders against the JAX package's, on the same
inputs:

  * the host prefix beam (``ops/ctc_beam.py``): the transcripts and scores
    of ``tests/test_ctc_beam.py``'s cases (greedy merges, summed paths, a
    word LM fixing an ambiguity, the trie, the character LM, the batch
    decoder, the streaming decoder's words and timestamps, n-best) equal
    the JAX module's, on its Python path and on the native library, and
    the port's native decoder equals its Python one;
  * the on-device prefix beam (``ops/ctc_beam_device.py``) against
    ``ops/ctc_beam_tpu.ctc_beam_search_tpu``: ids, lengths and emission
    frames equal and scores within 1e-5, at tiny shapes, with shallow
    fusion, a zero length, the U cap, and streaming chunks equal to one
    pass;
  * ``FullyConnectedCTCDecoder`` with ``on_device_beam_width`` (and
    ``on_device_fusion``) against the JAX decoder on converted weights;
    ``use_language_model`` no longer refused: it sets the logits pickle's
    default, which ``Speech2Text`` infer writes and
    ``scripts_torch/decode.py`` decodes with an LM that
    ``scripts_torch/build_lm.py`` writes, as the JAX scripts do.
"""
import csv
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openseq2seq_tpu.decoders import \
    FullyConnectedCTCDecoder as JaxCTCDecoder
from openseq2seq_tpu.ops import ctc_beam as jax_beam
from openseq2seq_tpu.ops import ctc_beam_tpu as jax_device
from openseq2seq_tpu_torch.convert import (flax_from_state_dict,
                                           state_dict_from_flax)
from openseq2seq_tpu_torch.decoders import FullyConnectedCTCDecoder
from openseq2seq_tpu_torch.ops import ctc_beam, ctc_beam_device, \
    ctc_beam_native
from openseq2seq_tpu_torch.ops.arpa_lm import build_arpa
from openseq2seq_tpu_torch.ops.ngram_fusion import (build_label_lm,
                                                    dense_label_lm)
from jax_global_state import jax_globals, jax_globals_module  # noqa: F401
from test_torch_text_data import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALPHABET = [" ", "a", "b", "c", "t"]     # blank: id 5
BLANK = len(ALPHABET)


def _probs_from_path(path_ids, V=6, peak=0.85):
    probs = np.full((len(path_ids), V), (1 - peak) / (V - 1), np.float64)
    for t, k in enumerate(path_ids):
        probs[t, k] = peak
    return probs


def _framed(chars, last=None):
    frames = []
    for k in chars:
        row = np.full(6, 0.01)
        row[k] = 0.95
        frames.append(row / row.sum())
    if last is not None:
        frames.append(last / last.sum())
    return np.stack(frames)


@pytest.fixture(scope="module")
def lms(tmp_path_factory):
    out = tmp_path_factory.mktemp("lm")
    word = build_arpa([["a", "cat"], ["a", "cat"], ["a", "cat"],
                       ["the", "cat"], ["a", "tab"]], str(out / "toy.arpa"),
                      order=2)
    char = build_arpa([list("acat"), list("acab"), list("acat"),
                       list("batcat"), list("atab")], str(out / "char.arpa"),
                      order=3)
    return {"word": word, "char": char}


def _ambiguous():
    x = np.full(6, 0.005)
    x[2], x[4] = 0.52, 0.465
    return _framed([1, BLANK, 0, 3, 1], x)


def _random_probs(seed, T, V=6, scale=2.0):
    logits = np.random.RandomState(seed).randn(T, V) * scale
    return np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)


# name: (probs, scorer kind or None, alpha, beta, beam)
HOST_CASES = {
    "merges": (lambda: _probs_from_path([1, 1, BLANK, 2, 2, BLANK, 1]),
               None, 0, 0, 8),
    "clean": (lambda: _probs_from_path([4, 1, 4, BLANK, 1], peak=0.95),
              None, 0, 0, 8),
    "sums_paths": (lambda: np.array([[0.0, 0.4, 0.35, 0.0, 0.0, 0.25]] * 2),
                   None, 0, 0, 20),
    "word_lm": (_ambiguous, "word", 2.0, 0.0, 30),
    "trie": (lambda: _framed([3, 4]), "word", 0.5, 0.0, 10),
    "char_lm": (lambda: _random_probs(3, 9), "char", 1.2, 0.3, 16),
    "random": (lambda: _random_probs(0, 15), None, 0, 0, 16),
    "random_word_lm": (lambda: _random_probs(1, 12), "word", 1.5, 0.5, 16),
}


def _decode_both(name, lms, native):
    """(port, JAX) results of one host case, through each package's
    dispatch (the native library where ``native``, else Python)."""
    make, kind, alpha, beta, beam = HOST_CASES[name]
    probs = make()
    out = []
    for mod in (ctc_beam, jax_beam):
        mod._get_native()
        saved = mod._NATIVE
        if not native:
            mod._NATIVE = None
        try:
            scorer = None if kind is None else mod.Scorer(
                alpha=alpha, beta=beta, model_path=lms[kind])
            out.append(mod.ctc_beam_search_decoder_batch(
                [probs], [len(probs)], ALPHABET, beam_size=beam,
                ext_scorer=scorer)[0])
        finally:
            mod._NATIVE = saved
    return out


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
@pytest.mark.parametrize("name", sorted(HOST_CASES))
def test_host_beam_equals_jax(name, native, lms):
    if native:
        assert ctc_beam_native.build() and ctc_beam_native.available()
    got, want = _decode_both(name, lms, native)
    assert [t for _, t in got] == [t for _, t in want]
    np.testing.assert_allclose([s for s, _ in got], [s for s, _ in want],
                               rtol=1e-12)
    if name == "word_lm":
        assert got[0][1] == "a cat"


def test_native_equals_python_and_nbest(lms):
    """The port's native decoder against its Python one (plain, word and
    character LM), and the n-best list against the JAX module's."""
    assert ctc_beam_native.build()
    for i in range(4):
        probs = _random_probs(10 + i, 8 + 2 * i)
        for kind, alpha, beta in ((None, 0, 0), ("word", 1.5, 0.5),
                                  ("char", 1.2, 0.3)):
            py = ctc_beam.ctc_beam_search_decoder(
                probs, ALPHABET, beam_size=16,
                ext_scorer=None if kind is None else ctc_beam.Scorer(
                    alpha, beta, lms[kind]))
            nat = ctc_beam_native.decode(
                probs, ALPHABET, beam_size=16,
                scorer=None if kind is None else
                ctc_beam_native.NativeScorer(alpha=alpha, beta=beta,
                                             arpa_path=lms[kind]))
            assert nat[0][1] == py[0][1]
            assert nat[0][0] == pytest.approx(py[0][0], rel=1e-3)
    probs = _ambiguous()
    got = ctc_beam.ctc_beam_search_decoder_nbest(
        probs, ALPHABET, 3, beam_size=30,
        ext_scorer=ctc_beam.Scorer(2.0, 0.0, lms["word"]))
    want = jax_beam.ctc_beam_search_decoder_nbest(
        probs, ALPHABET, 3, beam_size=30,
        ext_scorer=jax_beam.Scorer(2.0, 0.0, lms["word"]))
    assert got == want and len(got) == 3


def test_streaming_decoder_and_trie_equal_jax():
    chunks = [_probs_from_path([4, 1], peak=0.95),
              _probs_from_path([0, 2], peak=0.95)]
    for native in (False, True):
        results = []
        for mod in (ctc_beam, jax_beam):
            mod._get_native()
            saved = mod._NATIVE
            if not native:
                mod._NATIVE = None
            try:
                dec = mod.BeamDecoder(ALPHABET, beam_size=8)
                texts = [dec.decode(c.astype(np.float32)) for c in chunks]
                results.append((texts, dec.get_word_timestamps()))
            finally:
                mod._NATIVE = saved
        assert results[0] == results[1]
        assert results[0][0] == ["ta", "ta b"]
        assert [tuple(w) for w in results[0][1]] == [("ta", 0, 1),
                                                     ("b", 3, 3)]
    trie = ctc_beam.CharTrie.from_words(["cat", "cab", "a"])
    assert trie.walk("ca").children.keys() == {"t", "b"}
    assert ctc_beam.ctc_greedy_decoder(
        _probs_from_path([1, 1, BLANK, 2, 2, BLANK, 1]), ALPHABET) == "aba"


# ---------------------------------------------------------------------------
# the on-device beam
# ---------------------------------------------------------------------------

def _both_device(logits, lengths, K, U, fusion=None, frames=True):
    """(port, JAX) ids, lengths, scores (and frames) as numpy."""
    jf = None if fusion is None else jax_device.FusionLM(
        jnp.asarray(fusion[0]), *fusion[1:])
    tf = None if fusion is None else ctc_beam_device.FusionLM(
        torch.from_numpy(fusion[0]), *fusion[1:])
    want = jax.jit(lambda lg, ln: jax_device.ctc_beam_search_tpu(
        lg, ln, beam_width=K, max_label_len=U, fusion=jf,
        return_frames=frames))(jnp.asarray(logits), jnp.asarray(lengths))
    got = ctc_beam_device.ctc_beam_search_device(
        torch.from_numpy(logits), torch.from_numpy(lengths), beam_width=K,
        max_label_len=U, fusion=tf, return_frames=frames)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def _assert_beams_equal(got, want):
    for i in (0, 1) + ((3,) if len(want) > 3 else ()):
        np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_beam_equals_jax(seed):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(3, 12, 6) * 2.0).astype(np.float32)
    got, want = _both_device(logits, np.array([12, 9, 5], np.int32), K=8,
                             U=12)
    _assert_beams_equal(got, want)
    assert got[0].dtype == np.int32 and got[1].dtype == np.int32


@pytest.fixture(scope="module")
def char_fusion(tmp_path_factory):
    labels = ("a", "b", "c", " ")
    arpa = build_label_lm(["abc ab", "ab abc", "cab ba", "abc abc"] * 4,
                          str(tmp_path_factory.mktemp("fusion") /
                              "char.arpa"), order=3)
    table, C, m, init_ctx = dense_label_lm(arpa, labels, order=3)
    return arpa, labels, (np.asarray(table, np.float32), C, m, init_ctx)


def test_device_beam_with_fusion_equals_jax(char_fusion):
    _, _, (table, C, m, init_ctx) = char_fusion
    logits = (np.random.RandomState(11).randn(2, 10, 5) * 1.5).astype(
        np.float32)
    got, want = _both_device(logits, np.array([10, 8], np.int32), K=8,
                             U=10, fusion=(table, C, m, init_ctx, 0.6, 0.25))
    _assert_beams_equal(got, want)


def test_device_beam_zero_length_and_u_cap():
    logits = np.random.RandomState(9).randn(2, 8, 5).astype(np.float32)
    got, want = _both_device(logits, np.array([0, 8], np.int32), K=4, U=8)
    _assert_beams_equal(got, want)
    assert got[1][0, 0] == 0 and got[2][0, 0] == pytest.approx(0.0,
                                                               abs=1e-6)
    hot = np.full((1, 8, 3), -9.0, np.float32)
    hot[0, :, 0] = 9.0
    hot[0, 4:, 1] = 19.0
    got, want = _both_device(hot, np.array([8], np.int32), K=4, U=2)
    _assert_beams_equal(got, want)
    assert got[1][0, 0] <= 2 and np.all(got[0][0, 0, :got[1][0, 0]] >= 0)


def test_device_streaming_equals_one_pass(char_fusion):
    """Chunked updates give the one-pass beams bit for bit (frames
    utterance-absolute), with fusion too."""
    _, _, (table, C, m, init_ctx) = char_fusion
    rng = np.random.RandomState(21)
    logits = (rng.randn(2, 12, 5) * 2.0).astype(np.float32)
    lengths = np.array([12, 10], np.int32)
    for fusion in (None, ctc_beam_device.FusionLM(
            torch.from_numpy(table), C, m, init_ctx, 0.5, 0.1)):
        whole = ctc_beam_device.ctc_beam_search_device(
            torch.from_numpy(logits), torch.from_numpy(lengths),
            beam_width=8, max_label_len=12, fusion=fusion,
            return_frames=True)
        state = ctc_beam_device.ctc_beam_init(2, 8, 12, fusion)
        for start, stop in ((0, 5), (5, 9), (9, 12)):
            valid = np.clip(lengths - start, 0, stop - start)
            state, beams = ctc_beam_device.ctc_beam_update(
                state, torch.from_numpy(logits[:, start:stop]),
                torch.from_numpy(valid), fusion)
        assert state[-1].tolist() == lengths.tolist()
        for a, b in zip(beams, whole):
            assert torch.equal(a, b)


def _ctc_decoders(params, mode="infer"):
    """(JAX module, its variables, port module on them)."""
    jdec = JaxCTCDecoder(params, None, mode=mode).make_module()
    dec = FullyConnectedCTCDecoder(params, None, mode=mode).make_module(
        7, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(3)
    tree = jax.tree_util.tree_map(
        lambda v: (v + 0.3 * rng.randn(*v.shape)).astype(np.float32),
        flax_from_state_dict(dec.state_dict()))
    dec.load_state_dict(state_dict_from_flax(tree))
    return jdec, {"params": tree["params"]}, dec


@pytest.mark.parametrize("fused", [False, True], ids=["beam", "fusion"])
def test_fc_ctc_decoder_on_device_beam(fused, char_fusion):
    """The refusal of ``on_device_beam_width`` is lifted: the decoder's
    in-step decode is the beam, as the JAX decoder's."""
    arpa, labels, _ = char_fusion
    params = {"tgt_vocab_size": 5, "use_language_model": False,
              "on_device_beam_width": 4}
    if fused:
        params["on_device_fusion"] = {"lm_path": arpa, "labels": labels,
                                      "alpha": 0.7, "beta": 0.2}
    jdec, variables, dec = _ctc_decoders(params)
    x = np.random.RandomState(5).randn(2, 9, 7).astype(np.float32)
    lens = np.array([9, 6], np.int32)
    want = jax.jit(lambda v, e: jdec.apply(v, e, False))(
        variables, {"encoder_output": {"outputs": jnp.asarray(x),
                                       "src_length": jnp.asarray(lens)}})
    with torch.no_grad():
        got = dec({"encoder_output": {"outputs": torch.from_numpy(x),
                                      "src_length": torch.from_numpy(lens)}},
                  False)
    assert "fusion_table" not in dec.state_dict()
    for g, w in zip(got["outputs"], want["outputs"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got["beam_scores"].numpy(),
                               np.asarray(want["beam_scores"]), rtol=1e-5,
                               atol=1e-5)
    assert got["outputs"][0].shape == (2, 9)


def test_use_language_model_pickles_logits_for_decode_py(tmp_path, capsys):
    """``use_language_model`` is accepted (the legacy keys print their
    note); infer through ``Speech2Text`` pickles ``{wav: logits[:len]}``;
    ``scripts_torch/build_lm.py`` writes the ARPA and
    ``scripts_torch/decode.py`` decodes the pickle to the JAX script's
    WER lines and CSV."""
    from openseq2seq_tpu_torch.models import Speech2Text
    from openseq2seq_tpu_torch.test_utils import toy_speech
    import runpy
    data = str(tmp_path / "toy")
    csv_path, vocab = toy_speech.generate(data)
    dec = FullyConnectedCTCDecoder({"tgt_vocab_size": 5,
                                    "use_language_model": True,
                                    "trie_path": "x"}, None, mode="infer")
    assert dec.params["infer_logits_to_pickle"] is False
    assert "has no effect" in capsys.readouterr().out

    params = dict(runpy.run_path(os.path.join(
        REPO, "example_configs_torch", "speech2text",
        "w2lplus_toy.py"))["base_params"])
    params["data_layer_params"] = dict(params["data_layer_params"],
                                       dataset_files=[csv_path],
                                       vocab_file=vocab)
    params["decoder_params"] = {"use_language_model": True,
                                "infer_logits_to_pickle": True}
    params["encoder_params"] = dict(params["encoder_params"], convnet_layers=[
        {"type": "conv1d", "repeat": 1, "kernel_size": [5], "stride": [2],
         "num_channels": 16, "padding": "SAME"}])
    model = Speech2Text(params, mode="infer", device="cpu")
    batch = next(iter(model.get_data_layer().iterate_one_epoch()))
    state = model.init_state(batch)
    from openseq2seq_tpu_torch.training import trainer
    dump = str(tmp_path / "logits.pkl")
    out = trainer.to_host(model.eval_step(state, batch))
    model.finalize_inference([model.infer(batch, out)], dump)
    with open(dump, "rb") as f:
        logits = pickle.load(f)
    dec_out = out["outputs"]["decoder_output"]
    assert len(logits) == 10
    for i, (wav, lg) in enumerate(sorted(logits.items())):
        assert lg.shape == (int(dec_out["src_length"][i]), 10)

    corpus = tmp_path / "corpus.txt"
    with open(csv_path) as f:
        corpus.write_text("\n".join(r["transcript"]
                                    for r in csv.DictReader(f)) + "\n")
    arpa = str(tmp_path / "lm.arpa")
    build = runpy.run_path(os.path.join(REPO, "scripts_torch", "build_lm.py"))
    assert build["main"](["--corpus", str(corpus), "--out", arpa,
                          "--order", "2"]) == 0
    args = ["--logits", dump, "--labels", csv_path, "--vocab", vocab,
            "--lm", arpa, "--alpha", "0.5", "--alpha_max", "1.0",
            "--beta", "0.0", "--beam_width", "8"]
    outs = []
    for script in (os.path.join(REPO, "scripts_torch", "decode.py"),
                   os.path.join(REPO, "scripts", "decode.py")):
        capsys.readouterr()
        result = str(tmp_path / (os.path.basename(os.path.dirname(script))
                                 + ".csv"))
        assert runpy.run_path(script)["main"](
            args + ["--infer_output_file", result]) == 0
        with open(result) as f:
            outs.append((capsys.readouterr().out, f.read()))
    assert outs[0] == outs[1]
    assert "BEST: alpha=" in outs[0][0] and len(outs[0][1].splitlines()) == 11
