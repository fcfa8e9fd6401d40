"""The port's streaming ASR (``apps/frame_asr.py``) against the JAX
package's, on converted weights and the same audio.

``FrameASR``: a small Wave2Letter model (``w2l_test_config``'s layout,
random weights, batch-norm statistics randomized) built in
``interactive_infer`` mode on both sides, streamed over the first toy wav
at 0.1 s frames with 0.1 s of overlap (a 0.3 s buffer: 31 feature
frames). Each window's ``_infer_logits`` against the JAX one's; then
each streaming decoder (greedy merge, the host ``BeamDecoder``, the
device beam carried across chunks) is fed the JAX side's logits on both
sides, and gives the JAX decoder's text and word timestamps. Text from
random weights alone would prove little: near-ties flip the argmax, so
the decoders are compared on the same logits.

``TransducerFrameASR``: the tiny Conformer-Transducer of
``transducer_test_config`` (both packages' copies), streamed at 0.16 s
frames with 0.16 s of overlap (49 feature frames, 13 after the 4x
subsampling): each window's emitted ids, emission frames and carried
prediction-net state against the JAX decoder's, the carry of each side
fed back to that side. Then the stream's text and timestamps.

Tolerance: fp32 logits and carries rtol 1e-4, atol 1e-5; ids, texts,
frames exact."""
import os

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from openseq2seq_tpu.apps.frame_asr import FrameASR as JaxFrameASR
from openseq2seq_tpu.apps.frame_asr import \
    TransducerFrameASR as JaxTransducerFrameASR
from openseq2seq_tpu.models import Speech2Text as JaxSpeech2Text
from openseq2seq_tpu.test_utils.test_speech_configs import (
    transducer_test_config as jax_transducer_config,
    w2l_test_config as jax_w2l_config)
from openseq2seq_tpu_torch.apps.frame_asr import (FrameASR,
                                                  TransducerFrameASR)
from openseq2seq_tpu_torch.convert import state_dict_from_flax
from openseq2seq_tpu_torch.models import Speech2Text
from openseq2seq_tpu_torch.test_utils.test_speech_configs import (
    transducer_test_config, w2l_test_config)
from jax_global_state import jax_globals, jax_globals_module  # noqa: F401
from test_torch_tdnn import randomize
from test_torch_text_data import one_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5


def _narrow(params):
    """w2l_test_config at a third of its widths."""
    for layer in params["encoder_params"]["convnet_layers"]:
        layer["num_channels"] //= 3
    return params


def _signal(toy, n):
    _, signal = wavfile.read(os.path.join(toy["dir"], "toy_0.wav"))
    signal = signal.astype(np.float32) / 32767.0
    pad = (-len(signal)) % n
    return np.concatenate([signal, (np.random.RandomState(7).randn(pad) *
                                    1e-3).astype(np.float32)])


def _pair(toy, port_config, jax_config, asr_cls, jax_cls, seed, **kw):
    """(port streamer, JAX streamer) on the same randomized weights."""
    port = port_config(toy["csv"], toy["vocab"])[0]
    jp = jax_config(toy["csv"], toy["vocab"])[0]
    if port_config is w2l_test_config:
        port, jp = _narrow(port), _narrow(jp)
    jasr = jax_cls(JaxSpeech2Text(params=jp, mode="interactive_infer"),
                   **kw)
    variables = randomize({"params": jasr.state.params,
                           **dict(jasr.state.model_state)}, seed=seed)
    jasr.state = jasr.state.replace(
        params=variables["params"],
        model_state={k: v for k, v in variables.items() if k != "params"})
    asr = asr_cls(Speech2Text(params=port, mode="interactive_infer",
                              device="cpu"), **kw)
    asr.state.module.load_state_dict(state_dict_from_flax(variables))
    return asr, jasr


STREAM = dict(frame_len=0.1, frame_overlap=0.1, timestep_duration=0.01)


@pytest.fixture(scope="module")
def ctc_windows(toy_speech_data, jax_globals_module):  # noqa: F811
    """The buffers of the stream (the toy wav, then the flush's comfort
    noise) and each one's logits from both sides."""
    asr, jasr = _pair(toy_speech_data, w2l_test_config, jax_w2l_config,
                      FrameASR, JaxFrameASR, seed=5, **STREAM)
    signal = _signal(toy_speech_data, asr.n_frame_len)
    n = asr.n_frame_len
    frames = [signal[i:i + n] for i in range(0, len(signal), n)]
    frames += [asr._noise(n) for _ in range(
        asr.n_frame_overlap // n + 1)]
    buffers, got, want = [], [], []
    buf = jasr.buffer.copy()
    assert np.array_equal(buf, asr.buffer)
    for f in frames:
        buf = np.concatenate([buf[n:], f])
        buffers.append(buf)
        got.append(asr._infer_logits(buf))
        want.append(jasr._infer_logits(buf))
    return {"frames": frames, "got": got, "want": want,
            "vocab": asr.vocab, "toy": toy_speech_data}


def test_frame_asr_logits_match_jax(ctc_windows):
    assert len(ctc_windows["got"]) >= 8
    for got, want in zip(ctc_windows["got"], ctc_windows["want"]):
        assert got.shape == want.shape == (31, 10)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _stream(asr, frames, logits):
    """Transcribe ``frames`` with each window's logits taken from
    ``logits`` (and the device beam's as a tensor); returns the text as
    the demo collects it and the word timestamps."""
    it = iter(logits)
    asr._infer_logits = lambda buf: next(it)
    asr._device_logits = lambda buf: torch.tensor(next(it))
    beam = asr._beam_decoder is not None or bool(asr._dev_beam)
    text = ""
    for f in frames:
        piece = asr.transcribe(f)
        text = (piece or text) if beam else text + piece
    return text, asr.get_word_timestamps()


@pytest.mark.parametrize("decoder", ["greedy", "host_beam", "device_beam"])
def test_streaming_decoders_match_jax(ctc_windows, decoder,
                                      jax_globals):  # noqa: F811
    kw = dict(STREAM, silence_threshold=0.0)
    if decoder != "greedy":
        kw.update(beam_width=4, on_device_beam=decoder == "device_beam",
                  max_transcript_len=32)
    asr, jasr = _pair(ctc_windows["toy"], w2l_test_config, jax_w2l_config,
                      FrameASR, JaxFrameASR, seed=5, **kw)
    if decoder == "device_beam":
        assert asr._beam_decoder is None and asr._dev_beam
    got = _stream(asr, ctc_windows["frames"], ctc_windows["want"])
    want = _stream(jasr, ctc_windows["frames"], ctc_windows["want"])
    assert got[0] == want[0] and len(got[0]) > 0
    assert [tuple(w) for w in got[1]] == [tuple(w) for w in want[1]]
    if decoder != "greedy":
        assert got[1]


def _tree_close(got, want):
    got, want = jax.tree_util.tree_leaves(got), \
        jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32),
                                   rtol=RTOL, atol=ATOL)


def test_transducer_frame_asr_matches_jax(toy_speech_data,
                                          jax_globals):  # noqa: F811
    kw = dict(frame_len=0.16, frame_overlap=0.16, timestep_duration=0.04,
              silence_threshold=0.0)
    asr, jasr = _pair(toy_speech_data, transducer_test_config,
                      jax_transducer_config, TransducerFrameASR,
                      JaxTransducerFrameASR, seed=6, **kw)
    assert (asr.n_timesteps_overlap, asr.n_timesteps_frame) == (4, 4)
    runs = {"port": [], "jax": []}
    for side, a in (("port", asr), ("jax", jasr)):
        run = a._run_model

        def spy(signal, extra=None, run=run, out=runs[side]):
            dec = run(signal, extra)
            out.append(dec)
            return dec
        a._run_model = spy
    signal = _signal(toy_speech_data, asr.n_frame_len)
    n = asr.n_frame_len
    texts = ["", ""]
    for i in range(0, len(signal), n):
        texts[0] += asr.transcribe(signal[i:i + n])
        texts[1] += jasr.transcribe(signal[i:i + n])
    assert len(runs["port"]) == len(runs["jax"]) >= 5
    for got, want in zip(runs["port"], runs["jax"]):
        ids, n_ids = (x.numpy() for x in got["outputs"])
        want_ids, want_n = (np.asarray(x) for x in want["outputs"])
        np.testing.assert_array_equal(n_ids, want_n)
        np.testing.assert_array_equal(ids[0, :n_ids[0]],
                                      want_ids[0, :want_n[0]])
        np.testing.assert_array_equal(
            got["emit_frames"].numpy()[0, :n_ids[0]],
            np.asarray(want["emit_frames"])[0, :want_n[0]])
        _tree_close([[x.numpy() for x in hc] for hc in
                     got["decode_carry"][0]] +
                    [got["decode_carry"][1].numpy()],
                    [[np.asarray(x) for x in hc] for hc in
                     want["decode_carry"][0]] +
                    [np.asarray(want["decode_carry"][1])])
    assert texts[0] == texts[1] == asr.text
    assert asr._times == jasr._times
    assert asr.get_word_timestamps() == jasr.get_word_timestamps()
