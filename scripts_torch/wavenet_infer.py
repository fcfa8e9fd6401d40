#!/usr/bin/env python3
"""Autoregressive WaveNet synthesis from a checkpoint through the PyTorch
port (the twin of ``scripts/wavenet_infer.py``): the fast generation of
``openseq2seq_tpu_torch/encoders/wavenet_encoder.py::wavenet_generate``,
conditioned on the mel frames of the config's first eval example (or
none with ``--unconditioned``), on the card unless ``--device=cpu``.
Prints the generation's seconds and samples per second, with the
device's name.

Usage:
  python3 scripts_torch/wavenet_infer.py --config_file=<wavenet config> \\
      --logdir=<checkpoint dir> --n_samples=16000 --output=out.wav \\
      [--temperature=0.9] [--seed=0] [--device=cpu]

Without a checkpoint in the logdir it synthesizes from the seeded initial
weights (and says so).
"""
from __future__ import annotations

import argparse
import os
import runpy
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config_file", required=True)
    p.add_argument("--logdir", default=None,
                   help="checkpoint dir (defaults to the config's)")
    p.add_argument("--n_samples", type=int, default=16000)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0,
                   help="the sampling generator's seed")
    p.add_argument("--output", default="wavenet_syn.wav")
    p.add_argument("--unconditioned", action="store_true",
                   help="skip mel conditioning")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    import torch
    from scipy.io import wavfile

    from openseq2seq_tpu_torch.training.trainer import restore_state
    from openseq2seq_tpu_torch.utils.config import _latest_checkpoint

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device=cpu to run on the "
                         "CPU")
    module = runpy.run_path(args.config_file)
    cfg = dict(module["base_params"])
    for key, value in (module.get("infer_params") or {}).items():
        cfg[key] = dict(cfg.get(key, {}), **value) \
            if isinstance(value, dict) else value
    model = module["base_model"](params=cfg, mode="eval",
                                 device=args.device)
    logdir = args.logdir or cfg.get("logdir")
    ckpt = _latest_checkpoint(logdir) if logdir else None
    state = restore_state(model, ckpt)
    print("Restored {}".format(ckpt) if ckpt else
          "WARNING: no checkpoint found: synthesizing from the seeded "
          "initial weights")

    cond = None
    if not args.unconditioned:
        batch = next(iter(model.get_data_layer().iterate_one_epoch()))
        cond = np.asarray(batch["source_tensors"][2][:1])
    generator = torch.Generator(device=args.device).manual_seed(args.seed)
    if args.device == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    wav = model.generate(state, conditioning=cond, n_samples=args.n_samples,
                         temperature=args.temperature,
                         generator=generator)[0]
    seconds = time.time() - t0
    sr = model.get_data_layer().params.get("sample_freq", 22050)
    peak = float(np.max(np.abs(wav))) or 1.0
    wavfile.write(args.output, sr,
                  (wav / peak * 0.9 * 32767).astype(np.int16))
    name = torch.cuda.get_device_name(0) if args.device == "cuda" else "CPU"
    print("Wrote {} samples at {} Hz to {}: generated in {:.2f} s, {:.1f} "
          "samples/s ({})".format(len(wav), sr, args.output, seconds,
                                  len(wav) / seconds, name))
    return 0


if __name__ == "__main__":
    sys.exit(main())
