"""Toy Wave2Letter+-style config on the synthetic speech set, for the
PyTorch port: the twin of ``example_configs/speech2text/w2lplus_toy.py``,
key for key, the smallest end-to-end config (trains to a validation WER
of 0 in 150 epochs of 10 utterances, on the CPU in a few minutes).

Generates the toy dataset on first use under ``os2s_toy_speech`` in the
temporary directory (or ``OS2S_TOY_DATA_DIR``).

Run:
  python -m openseq2seq_tpu_torch.run --mode=train_eval --device=cpu \
      --config_file=example_configs_torch/speech2text/w2lplus_toy.py
"""
import os
import tempfile

import torch

from openseq2seq_tpu_torch.data.speech2text import Speech2TextDataLayer
from openseq2seq_tpu_torch.decoders import FullyConnectedCTCDecoder
from openseq2seq_tpu_torch.encoders import TDNNEncoder
from openseq2seq_tpu_torch.losses import CTCLoss
from openseq2seq_tpu_torch.models import Speech2Text
from openseq2seq_tpu_torch.test_utils import toy_speech

_DATA_DIR = os.environ.get("OS2S_TOY_DATA_DIR", os.path.join(
    tempfile.gettempdir(), "os2s_toy_speech"))
if not os.path.exists(os.path.join(_DATA_DIR, "toy_data.csv")):
    toy_speech.generate(_DATA_DIR)
_CSV = os.path.join(_DATA_DIR, "toy_data.csv")
_VOCAB = os.path.join(_DATA_DIR, "vocab.txt")

base_model = Speech2Text

base_params = {
    "random_seed": 0,
    "num_epochs": 150,
    "logdir": os.environ.get("OS2S_TOY_LOGDIR", os.path.join(
        tempfile.gettempdir(), "os2s_torch_toy_logs")),
    "batch_size_per_gpu": 10,
    "print_loss_steps": 25,
    "eval_steps": 75,
    "save_checkpoint_steps": 75,
    "num_checkpoints": 2,

    "optimizer": "Adam",
    "optimizer_params": {"learning_rate": 3e-4},
    "lr_policy": "poly_decay",
    "lr_policy_params": {"power": 0.5, "decay_steps": 10000},
    "dtype": "float32",
    "max_grad_norm": 5.0,

    "encoder": TDNNEncoder,
    "encoder_params": {
        "convnet_layers": [
            {"type": "conv1d", "repeat": 2, "kernel_size": [7],
             "stride": [1], "num_channels": 64, "padding": "SAME"},
            {"type": "conv1d", "repeat": 2, "kernel_size": [11],
             "stride": [1], "num_channels": 96, "padding": "SAME",
             "residual": True},
            {"type": "conv1d", "repeat": 1, "kernel_size": [1],
             "stride": [1], "num_channels": 128, "padding": "SAME"},
        ],
        "activation_fn": torch.relu,
        "dropout_keep_prob": 1.0,
        "normalization": "batch_norm",
        "use_conv_mask": True,
    },
    "decoder": FullyConnectedCTCDecoder,
    "decoder_params": {"use_language_model": False},
    "loss": CTCLoss,
    "loss_params": {},

    "data_layer": Speech2TextDataLayer,
    "data_layer_params": {
        "num_audio_features": 40,
        "input_type": "logfbank",
        "vocab_file": _VOCAB,
        "dataset_files": [_CSV],
        "pad_to": 16,
        "norm_per_feature": True,
        "window": "hanning",
        "precompute_mel_basis": True,
        "sample_freq": 16000,
    },
}

train_params = {"data_layer_params": {"shuffle": True}}
eval_params = {"data_layer_params": {"shuffle": False}}
infer_params = {"data_layer_params": {"shuffle": False}}
