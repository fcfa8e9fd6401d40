"""Tacotron-2 with Global Style Tokens at full width on synthetic
batches, for the PyTorch port: ``tacotron2_synthetic.py`` plus the JAX
recipe ``example_configs/text2speech/tacotron_gst.py``'s
``style_embedding_params`` (10 tokens, 256 units, 4 heads, six 3x3
stride-2 convs of 32, 32, 64, 64, 128, 128 channels, a 128-unit GRU).
Under ``fused_rnn`` the style encoder's GRU runs on kernel B4 over the 512
/ 2^6 = 8 frames the convs leave, beside the encoder's LSTM on B3. The
style comes from each batch's target spectrogram, which the synthetic
layer gives in every mode.

Run:
  python -m openseq2seq_tpu_torch.run --mode=train --logdir=<dir> \\
      --config_file=example_configs_torch/text2speech/tacotron_gst_synthetic.py
"""
import copy
import os
import runpy

_base = runpy.run_path(os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "tacotron2_synthetic.py"))

base_model = _base["base_model"]
base_params = copy.deepcopy(_base["base_params"])
train_params = {"max_steps": 3}
eval_params = _base["eval_params"]
infer_params = _base["infer_params"]

base_params["encoder_params"]["style_embedding_enable"] = True
base_params["encoder_params"]["style_embedding_params"] = {
    "num_tokens": 10,
    "num_units": 256,
    "attention_heads": 4,
    "conv_layers": [32, 32, 64, 64, 128, 128],
    "num_rnn_units": 128,
}
