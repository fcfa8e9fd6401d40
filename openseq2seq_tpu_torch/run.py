"""CLI entry point of the port (the counterpart of the repository's
``run.py``):

    python -m openseq2seq_tpu_torch.run --config_file=<config> --mode=eval

Modes ``eval`` and ``infer`` run; ``train`` and ``train_eval`` land with
training, ``interactive_infer`` after it. Config files and CLI overrides
(``--a/b/c value``) follow the repository's contract; a config binds the
port's classes (see ``example_configs_torch/``). The model runs on the
first CUDA device when there is one, else on the CPU, and restores the
latest checkpoint of ``logdir``.
"""
from __future__ import annotations

import sys

import torch

from openseq2seq_tpu.utils.config import (check_logdir, configs_for_modes,
                                          get_base_config)
from openseq2seq_tpu.utils.logging import deco_print, enable_logs

from .training import trainer


def main(argv=None):
    """Run one mode; returns the eval metrics or the infer results."""
    argv = argv if argv is not None else sys.argv[1:]
    args, base_config, base_model, config_module = get_base_config(argv)
    if args.mode not in ("eval", "infer"):
        raise NotImplementedError(
            "--mode={} is not ported yet: train and train_eval land with "
            "training, interactive_infer after it".format(args.mode))
    if args.benchmark:
        raise NotImplementedError("--benchmark lands with training")
    if args.enable_logs and base_config.get("logdir"):
        enable_logs(base_config["logdir"])

    restore_checkpoint = check_logdir(args, base_config)
    config = configs_for_modes(args, base_config, config_module)[args.mode]
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    deco_print("Device: {}".format(device))
    model = base_model(params=config, mode=args.mode, device=device)
    if args.mode == "eval":
        return trainer.evaluate(model, restore_checkpoint)
    return trainer.infer(model, restore_checkpoint, args.infer_output_file)


if __name__ == "__main__":
    main()
