"""The toy config of ``docs/extending-walkthrough.md`` for the PyTorch
port: ``w2lplus_toy.py`` with its encoder swapped for the walkthrough's
``GatedConvEncoder`` (3 gated blocks of width 160, kernel 5, keep 0.9), as
``tests/test_extending_tutorial.py`` trains it (60 epochs of the 10 toy
utterances, to an eval loss below 1.0).

Run:
  python -m openseq2seq_tpu_torch.run --mode=train_eval --device=cpu \\
      --config_file=example_configs_torch/speech2text/gatedconv_toy.py
"""
import os
import runpy
import tempfile

from openseq2seq_tpu_torch.encoders import GatedConvEncoder

_here = os.path.dirname(os.path.abspath(__file__))
_base = runpy.run_path(os.path.join(_here, "w2lplus_toy.py"))

base_model = _base["base_model"]
base_params = dict(_base["base_params"])
base_params["encoder"] = GatedConvEncoder
base_params["encoder_params"] = {
    "num_layers": 3,
    "hidden_size": 160,
    "kernel_size": 5,
    "dropout_keep_prob": 0.9,
}
# 60 steps of 10 utterances; eval and a checkpoint at the last
base_params.update(num_epochs=60, eval_steps=60, save_checkpoint_steps=60)
base_params["logdir"] = os.environ.get("OS2S_TOY_LOGDIR", os.path.join(
    tempfile.gettempdir(), "os2s_torch_gatedconv_toy_logs"))
eval_params = _base.get("eval_params", {})
infer_params = _base.get("infer_params", {})
