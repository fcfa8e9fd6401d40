"""Centaur at ``centaur_float.py``'s width on synthetic LJSpeech-shaped
batches, for the PyTorch port: the recipe's network key for key (a
256-wide encoder of four SAME conv blocks of k 3; a 512-wide decoder of a
2 x 512 prenet and four causal conv (k 5) and attention blocks, one head,
reduction 2, ``window_size`` 4 with ``back_step_size`` 0 forced on layers
1 and 3; fp32; NovoGrad with ``poly_decay``) on ``SyntheticTTSDataLayer``
batches of 32 texts of 96 characters x 512 frames of 80 mel bins (the
recipe's "both" sizes its decoder from the mel count, 80).
``infer_max_steps`` keeps its default of 200 frames (100 groups).

Run:
  python -m openseq2seq_tpu_torch.run --mode=train --logdir=<dir> \\
      --config_file=example_configs_torch/text2speech/centaur_synthetic.py
"""
import os
import runpy

from openseq2seq_tpu_torch.data import SyntheticTTSDataLayer

_recipe = runpy.run_path(os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "centaur_float.py"))

base_model = _recipe["base_model"]
base_params = {
    key: value for key, value in _recipe["base_params"].items()
    if key not in ("data_layer", "data_layer_params", "max_steps")}
base_params.update({
    "logdir": "centaur_synthetic_logs",
    "max_steps": 1000000,
    "print_loss_steps": None,
    "print_samples_steps": None,
    "data_layer": SyntheticTTSDataLayer,
    "data_layer_params": {
        "src_vocab_size": 94,
        "num_audio_features": 80,
        "text_length": 96,
        "spec_length": 512,
        "num_batches": 100,
    },
})
