"""CLI entry point of the port (the counterpart of the repository's
``run.py``):

    python -m openseq2seq_tpu_torch.run --config_file=<config> --mode=train

Modes ``train``, ``train_eval``, ``eval`` and ``infer`` run;
``interactive_infer`` is not ported yet. ``--continue_learning`` resumes
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
    if args.mode == "interactive_infer":
        raise NotImplementedError("--mode=interactive_infer is not ported "
                                  "yet")
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
    return trainer.infer(models["infer"], restore_checkpoint,
                         args.infer_output_file)


if __name__ == "__main__":
    main()
