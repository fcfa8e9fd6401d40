"""A tiny WaveNet, the CPU twin of ``wavenet_LJ.py`` for tests and quick
runs: the recipe's layout and training keys ("mixed", Adam 1e-3 with
``exp_decay``, ``max_grad_norm`` 1, batches of 2) at the toy's width (2
blocks x 3 gated layers of 16 filters, 64 mu-law channels, 2,048-sample
chunks at 16 kHz, 20 mel bins) on the toy's four tones
(``wavenet_toy.py``'s corpus, the same directory), 4 steps.

Run:
  python -m openseq2seq_tpu_torch.run --mode=train_eval --device=cpu \\
      --logdir=<dir> \\
      --config_file=example_configs_torch/text2speech/wavenet_tiny.py
"""
import copy
import os
import runpy

_here = os.path.dirname(os.path.abspath(__file__))
_toy = runpy.run_path(os.path.join(_here, "wavenet_toy.py"))
_recipe = runpy.run_path(os.path.join(_here, "wavenet_LJ.py"))

base_model = _toy["base_model"]
base_params = copy.deepcopy(_toy["base_params"])
del base_params["num_epochs"]
base_params.update({
    "max_steps": 4,
    "logdir": "wavenet_tiny_logs",
    "print_loss_steps": 1,
    "eval_steps": 2,
    "save_checkpoint_steps": 2,
    "dtype": _recipe["base_params"]["dtype"],
    "lr_policy": _recipe["base_params"]["lr_policy"],
    "lr_policy_params": _recipe["base_params"]["lr_policy_params"],
    "max_grad_norm": _recipe["base_params"]["max_grad_norm"],
})
eval_params = _toy["eval_params"]
infer_params = _toy["infer_params"]
