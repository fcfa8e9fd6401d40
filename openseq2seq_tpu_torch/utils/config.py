"""Config loading and CLI plumbing (the port's copy of
``openseq2seq_tpu/utils/config.py``, without its XLA compilation cache).

A config file is an executable Python module defining ``base_model`` (a
Model class) and ``base_params`` (a dict), plus optional
``train_params`` / ``eval_params`` / ``infer_params`` /
``interactive_infer_params`` per-mode override dicts. Every scalar leaf
of ``base_params`` is overridable from the CLI as ``--nested/key
value``. ``--benchmark`` rewrites the config for pure-throughput runs.
``--device`` picks the card (``cuda``, the default) or the CPU; the
port never falls back from one to the other.
"""
from __future__ import annotations

import argparse
import ast
import copy
import os
import runpy
from typing import Any, Dict, Optional, Tuple

from .logging import deco_print
from .params import flatten_dict, nest_dict, nested_update

MODES = ("train", "eval", "train_eval", "infer", "interactive_infer")
DEVICES = ("cuda", "cpu")


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Experiment parameters")
    parser.add_argument("--config_file", required=True,
                        help="Path to the configuration file")
    parser.add_argument("--mode", default="train",
                        help="One of {}".format(list(MODES)))
    parser.add_argument("--device", default="cuda", choices=DEVICES,
                        help="run on the first CUDA device (default) or, "
                             "when asked, on the CPU")
    parser.add_argument("--infer_output_file", default="infer-out.txt")
    parser.add_argument("--continue_learning", action="store_true",
                        help="resume training from the latest checkpoint")
    parser.add_argument("--no_dir_check", action="store_true",
                        help="skip logdir sanity checks")
    parser.add_argument("--benchmark", action="store_true",
                        help="automatic config change for benchmarking")
    parser.add_argument("--bench_steps", type=int, default=20)
    parser.add_argument("--bench_start", type=int, default=None)
    parser.add_argument("--enable_logs", action="store_true")
    return parser


def get_base_config(argv) -> Tuple[argparse.Namespace, Dict[str, Any],
                                   type, Dict[str, Any]]:
    """Parse CLI args, execute the config file, apply ``--a/b/c`` leaf
    overrides. Returns (args, base_config, base_model, config_module)."""
    parser = build_arg_parser()
    args, unknown = parser.parse_known_args(argv)

    if args.mode not in MODES:
        raise ValueError("Mode has to be one of {}".format(list(MODES)))

    config_module = runpy.run_path(args.config_file)
    base_config = config_module.get("base_params", None)
    if base_config is None:
        raise ValueError("base_params dictionary has to be defined "
                         "in the config file")
    base_model = config_module.get("base_model", None)
    if base_model is None:
        raise ValueError("base_model class has to be defined in the "
                         "config file")

    # expose every scalar leaf of base_params as a CLI flag; also a few
    # schema-optional top-level keys that configs commonly omit
    for key, default in (("num_model_partitions", 1),
                         ("num_data_partitions", 0),   # 0 = auto
                         ("iter_size", 1),
                         ("random_seed", 0),
                         ("print_samples_steps", 0)):  # 0 = off
        base_config.setdefault(key, default)
    override_parser = argparse.ArgumentParser()
    for path, value in flatten_dict(base_config).items():
        if isinstance(value, bool):
            override_parser.add_argument("--" + path, default=value,
                                         type=ast.literal_eval)
        elif isinstance(value, (int, float, str)):
            override_parser.add_argument("--" + path, default=value,
                                         type=type(value))
    overrides = override_parser.parse_args(unknown)
    nested_update(base_config, nest_dict(vars(overrides)))

    return args, base_config, base_model, config_module


def configs_for_modes(args, base_config, config_module):
    """Build per-mode configs: deep-copy base and merge the mode dict
    (reference `utils/utils.py:810-843`). Returns dict mode->config."""
    out = {}
    wants_train = args.mode in ("train", "train_eval")
    wants_eval = args.mode in ("eval", "train_eval")
    if wants_train:
        cfg = copy.deepcopy(base_config)
        if "train_params" in config_module:
            nested_update(cfg, copy.deepcopy(config_module["train_params"]))
        out["train"] = cfg
    if wants_eval:
        cfg = copy.deepcopy(base_config)
        if "eval_params" in config_module:
            nested_update(cfg, copy.deepcopy(config_module["eval_params"]))
        out["eval"] = cfg
    if args.mode == "infer":
        cfg = copy.deepcopy(base_config)
        if "infer_params" in config_module:
            nested_update(cfg, copy.deepcopy(config_module["infer_params"]))
        out["infer"] = cfg
    if args.mode == "interactive_infer":
        cfg = copy.deepcopy(base_config)
        if "interactive_infer_params" in config_module:
            nested_update(cfg, copy.deepcopy(
                config_module["interactive_infer_params"]))
        out["interactive_infer"] = cfg
    return out


def apply_benchmark_mode(config: Dict[str, Any], bench_steps: int,
                         bench_start: Optional[int]) -> Dict[str, Any]:
    """Benchmark rewrite (reference `utils/utils.py:846-864`): disable
    checkpoints/summaries/logs, run exactly ``bench_steps`` steps, time
    from ``bench_start``."""
    config = copy.deepcopy(config)
    config["print_samples_steps"] = None
    config["print_loss_steps"] = 1
    config["save_summaries_steps"] = None
    config["save_checkpoint_steps"] = None
    config["logdir"] = str(config.get("logdir", "") or "")
    config.pop("num_epochs", None)
    config["max_steps"] = bench_steps
    config["bench_start"] = bench_start if bench_start is not None else 10
    return config


def check_logdir(args, base_config) -> Optional[str]:
    """Resume-vs-fresh logdir semantics (reference `utils/utils.py:633-709`):

    * train without --continue_learning: logdir must be empty/absent;
    * train with --continue_learning: logdir must contain a checkpoint;
    * eval/infer: restore the latest checkpoint, or the newest
      "best_models" checkpoint when the config sets
      ``restore_best_checkpoint: True`` (reference run.py:34-40 +
      utils.py:683-689).

    Returns the checkpoint path to restore from, or None.
    """
    logdir = base_config.get("logdir", "")
    if args.benchmark or args.no_dir_check:
        return _latest_checkpoint(logdir) if args.continue_learning else None
    checkpoint = _latest_checkpoint(logdir)
    if args.mode in ("train", "train_eval"):
        if args.continue_learning:
            if checkpoint is None:
                raise OSError(
                    "The log_dir '{}' must contain a checkpoint to "
                    "continue learning".format(logdir))
            return checkpoint
        if checkpoint is not None:
            raise OSError(
                "Log directory '{}' already contains a checkpoint. "
                "Pass --continue_learning to resume or choose a new "
                "logdir".format(logdir))
        return None
    # eval / infer / interactive_infer need a checkpoint
    if base_config.get("restore_best_checkpoint"):
        best = _latest_checkpoint(logdir, subdir="best_models")
        if best is not None:
            deco_print("Restoring from the best checkpoint")
            return best
        deco_print("No best_models checkpoint yet; restoring from the "
                   "latest checkpoint")
    if checkpoint is None:
        raise OSError("There is no checkpoint in '{}' to restore "
                      "from".format(logdir))
    return checkpoint


def _latest_checkpoint(logdir: str,
                       subdir: str = "checkpoints") -> Optional[str]:
    """Find the newest step-numbered checkpoint dir under logdir/<subdir>."""
    if not logdir:
        return None
    ckpt_root = os.path.join(logdir, subdir)
    if not os.path.isdir(ckpt_root):
        return None
    steps = []
    for name in os.listdir(ckpt_root):
        if name.isdigit() and os.path.isdir(os.path.join(ckpt_root, name)):
            steps.append(int(name))
    if not steps:
        return None
    return os.path.join(ckpt_root, str(max(steps)))
