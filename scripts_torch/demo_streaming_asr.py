#!/usr/bin/env python
"""Streaming ASR demo on the port (the twin of
``scripts/demo_streaming_asr.py``; reference `demo_streaming_asr.py`,
which reads a microphone): streams a wav file frame by frame through
``FrameASR`` and prints the live transcript, then the final one.

  python scripts_torch/demo_streaming_asr.py \\
      --config_file=example_configs_torch/speech2text/w2lplus_toy.py \\
      --checkpoint=<logdir>/checkpoints/150 \\
      --wav=<toy data>/toy_0.wav [--device=cpu] \\
      [--beam_width=32 --lm=lm.arpa --alpha=1.0 --beta=0.5]

The model runs on the card unless ``--device=cpu`` is given (without a
card it raises). Transducer (RNN-T) models stream natively (the
prediction net's state carried, no CTC merge): pass ``--transducer`` and
a transducer config; ``--timestep_duration`` then includes the encoder's
time stride (the Conformer's: a 0.01 s hop x 4 = 0.04).
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from openseq2seq_tpu_torch.utils.config import get_base_config  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_file", required=True)
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--wav", required=True)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--frame_len", type=float, default=0.2)
    parser.add_argument("--frame_overlap", type=float, default=0.4)
    parser.add_argument("--timestep_duration", type=float, default=0.01)
    parser.add_argument("--beam_width", type=int, default=1)
    parser.add_argument("--lm", default=None)
    parser.add_argument("--alpha", type=float, default=2.0)
    parser.add_argument("--beta", type=float, default=0.5)
    parser.add_argument("--transducer", action="store_true",
                        help="stream through TransducerFrameASR (an RNN-T "
                             "config)")
    args = parser.parse_args(argv)

    import torch
    from scipy.io import wavfile
    from openseq2seq_tpu_torch.apps.frame_asr import (FrameASR,
                                                      TransducerFrameASR)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device=cpu to run on "
                           "the CPU")

    _, base_config, base_model, _ = get_base_config(
        ["--config_file", args.config_file])
    model = base_model(params=base_config, mode="interactive_infer",
                       device=args.device)
    common = dict(checkpoint=args.checkpoint, frame_len=args.frame_len,
                  frame_overlap=args.frame_overlap,
                  timestep_duration=args.timestep_duration)
    if args.transducer:
        asr = TransducerFrameASR(model, **common)
    else:
        asr = FrameASR(model, beam_width=args.beam_width,
                       language_model=args.lm, alpha=args.alpha,
                       beta=args.beta, **common)
    beam = args.beam_width > 1 and not args.transducer

    sr, signal = wavfile.read(args.wav)
    if signal.dtype.kind == "i":
        signal = signal.astype(np.float32) / np.iinfo(signal.dtype).max
    n = asr.n_frame_len
    pad = (-len(signal)) % n
    signal = np.concatenate([signal, np.random.RandomState(0).randn(
        pad).astype(np.float32) * 1e-3])

    transcript = ""
    for i in range(0, len(signal), n):
        piece = asr.transcribe(signal[i:i + n])
        # a beam returns the whole transcript so far, greedy the new text
        transcript = (piece or transcript) if beam else transcript + piece
        print("\r[{:6.2f}s] {}".format((i + n) / sr, transcript),
              end="", flush=True)
    tail = asr.flush()
    transcript = (tail or transcript) if beam else transcript + tail
    print("\nFinal transcript: {}".format(transcript.strip()))
    if beam or args.transducer:
        print("Word timestamps:", asr.get_word_timestamps())
    return 0


if __name__ == "__main__":
    sys.exit(main())
