"""CLI entry point of the port (the counterpart of the repository's
``run.py``):

    python -m openseq2seq_tpu_torch.run --config_file=<config> --mode=train

Modes ``train``, ``train_eval``, ``eval``, ``infer`` and
``interactive_infer`` run: the last reads standard input, a line at a
time, a wav path (speech recognition: its transcript is printed) or a
sentence (speech synthesis: the path of its Griffin-Lim wav is printed),
until end of input. ``--continue_learning`` resumes
training from the latest checkpoint of ``logdir``; without it, training
refuses a logdir that holds one. ``--benchmark`` rewrites the config for
a throughput run (``--bench_steps``, ``--bench_start``). Config files and
CLI overrides (``--a/b/c value``) follow the repository's contract,
through the port's ``utils/config.py``; a config binds the port's
classes (see ``example_configs_torch/``). The model runs on the first
CUDA device; ``--device=cpu`` asks for the CPU instead. Without a CUDA
device and without ``--device=cpu`` it raises: it never falls back.
"""
from __future__ import annotations

import sys

import torch

from .utils.config import (apply_benchmark_mode, check_logdir,
                           configs_for_modes, get_base_config)
from .utils.logging import deco_print, enable_logs

from .training import trainer


def main(argv=None):
    """Run one mode; returns the train result, the eval metrics or the
    infer results."""
    argv = argv if argv is not None else sys.argv[1:]
    args, base_config, base_model, config_module = get_base_config(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card; pass "
                           "--device=cpu to run on the CPU")
    if args.enable_logs and base_config.get("logdir"):
        enable_logs(base_config["logdir"])
    if args.benchmark:
        base_config = apply_benchmark_mode(base_config, args.bench_steps,
                                           args.bench_start)
        config_module = dict(config_module, base_params=base_config)

    restore_checkpoint = check_logdir(args, base_config)
    configs = configs_for_modes(args, base_config, config_module)
    device = torch.device(args.device)
    deco_print("Device: {}".format(device))
    models = {mode: base_model(params=cfg, mode=mode, device=device)
              for mode, cfg in configs.items()}
    if args.mode in ("train", "train_eval"):
        return trainer.train(models["train"], models.get("eval"),
                             checkpoint=restore_checkpoint)
    if args.mode == "eval":
        return trainer.evaluate(models["eval"], restore_checkpoint)
    if args.mode == "infer":
        return trainer.infer(models["infer"], restore_checkpoint,
                             args.infer_output_file)
    return interactive_repl(models["interactive_infer"], restore_checkpoint)


def interactive_repl(model, checkpoint, lines=None):
    """The stdin REPL of ``--mode=interactive_infer`` (the repository's
    ``run.py:73-120``): each line a wav path (its transcript printed) or,
    for a text-to-speech model, a sentence (synthesized by Griffin-Lim to
    ``interactive_synth_<n>.wav``, whose path is printed). A line that
    fails prints its error and the loop goes on. ``lines`` replaces
    standard input. Returns what it printed, a line an input."""
    import numpy as np
    from scipy.io import wavfile
    state = trainer.restore_state(model, checkpoint)
    dl = model.get_data_layer()
    is_tts = hasattr(model, "synthesize_wav")
    prompt = "text> " if is_tts else "wav> "
    deco_print("Interactive inference. Enter a {} per line (Ctrl-D to "
               "quit).".format("sentence" if is_tts else "wav path"))
    source = iter(lines) if lines is not None else None
    printed, n_synth = [], 0
    while True:
        try:
            line = (next(source) if source is not None
                    else input(prompt)).strip()
        except (EOFError, StopIteration):
            break
        if not line:
            continue
        try:
            batch = dl.create_interactive_batch(line)
            out = trainer.to_host(model.eval_step(state, batch))
            if is_tts:
                spec, lengths = out["outputs"]["decoder_output"]["outputs"]
                n = int(lengths[0])
                wav = model.synthesize_wav(np.asarray(spec)[0, :n])
                path = "interactive_synth_{}.wav".format(n_synth)
                n_synth += 1
                peak = float(np.max(np.abs(wav))) or 1.0
                wavfile.write(path, dl.params.get("sample_freq", 22050),
                              (wav / peak * 0.9 * 32767).astype(np.int16))
                text = path
            else:
                text = "\n".join(t for _, t in model.infer(batch, out))
        except Exception as e:  # the REPL goes on after a bad input
            text = "error: {}".format(e)
        print(text, flush=True)
        printed.append(text)
    return printed


if __name__ == "__main__":
    main()
