"""Jasper-Mini, the small-footprint separable-conv recipe, for the
PyTorch port: the twin of ``example_configs/speech2text/jasper_mini.py``,
key for key (reference `example_configs/speech2text/
jasper-Mini-for-Jetson.py`: 12 separable blocks up to 512 channels,
NovoGrad + LARC + poly decay, bf16 "mixed", batch 32), read from wav
files (``LIBRISPEECH_DIR``, as ``quartznet15x5_librispeech.py``):

  LIBRISPEECH_DIR=<dir> python -m openseq2seq_tpu_torch.run \\
      --mode=train \\
      --config_file=example_configs_torch/speech2text/jasper_mini.py
"""
import os

import torch

from openseq2seq_tpu_torch.data.speech2text import Speech2TextDataLayer
from openseq2seq_tpu_torch.decoders import FullyConnectedCTCDecoder
from openseq2seq_tpu_torch.encoders import TDNNEncoder
from openseq2seq_tpu_torch.losses import CTCLoss
from openseq2seq_tpu_torch.models import Speech2Text

_DATA = os.environ.get("LIBRISPEECH_DIR", "/data/librispeech")


def _block(repeat, kernel, ch, keep, residual=True):
    return {"type": "sep_conv1d", "repeat": repeat,
            "kernel_size": [kernel], "stride": [1], "num_channels": ch,
            "padding": "SAME", "dilation": [1],
            "dropout_keep_prob": keep, "residual": residual}


base_model = Speech2Text
base_params = {
    "random_seed": 0,
    "num_epochs": 400,
    "logdir": os.environ.get("OS2S_LOGDIR", "jasper_mini_log"),
    "batch_size_per_gpu": 32,
    "print_loss_steps": 10,
    "save_summaries_steps": 100,
    "eval_steps": 5000,
    "save_checkpoint_steps": 1000,

    "optimizer": "NovoGrad",
    "optimizer_params": {"beta1": 0.95, "beta2": 0.98, "epsilon": 1e-8,
                         "weight_decay": 0.001, "grad_averaging": False},
    "lr_policy": "poly_decay",
    "lr_policy_params": {"learning_rate": 0.02, "power": 2.0,
                         "decay_steps": 400000},
    "larc_params": {"larc_eta": 0.001},
    "dtype": "mixed",

    "encoder": TDNNEncoder,
    "encoder_params": {
        "convnet_layers": [
            {"type": "sep_conv1d", "repeat": 1, "kernel_size": [11],
             "stride": [2], "num_channels": 256, "padding": "SAME",
             "dilation": [1], "dropout_keep_prob": 0.8},
            _block(3, 11, 256, 0.8),
            _block(3, 11, 256, 0.8),
            _block(3, 13, 256, 0.8),
            _block(3, 13, 256, 0.8),
            _block(3, 17, 512, 0.8),
            _block(3, 17, 512, 0.8),
            _block(3, 21, 512, 0.7),
            _block(3, 21, 512, 0.7),
            _block(3, 25, 512, 0.7),
            _block(3, 25, 512, 0.7),
            {"type": "sep_conv1d", "repeat": 1, "kernel_size": [29],
             "stride": [1], "num_channels": 512, "padding": "SAME",
             "dilation": [2], "dropout_keep_prob": 0.6},
            {"type": "conv1d", "repeat": 1, "kernel_size": [1],
             "stride": [1], "num_channels": 1024, "padding": "SAME",
             "dilation": [1], "dropout_keep_prob": 0.6},
        ],
        "dropout_keep_prob": 0.7,
        "normalization": "batch_norm",
        "activation_fn": torch.relu,
        "use_conv_mask": True,
    },
    "decoder": FullyConnectedCTCDecoder,
    "decoder_params": {"use_language_model": False},
    "loss": CTCLoss,
    "loss_params": {},
    "data_layer": Speech2TextDataLayer,
    "data_layer_params": {
        "num_audio_features": 64,
        "input_type": "logfbank",
        "vocab_file": os.path.join(_DATA, "vocab.txt"),
        "dataset_files": [
            os.path.join(_DATA, "librivox-train-clean-100.csv"),
            os.path.join(_DATA, "librivox-train-clean-360.csv"),
            os.path.join(_DATA, "librivox-train-other-500.csv"),
        ],
        "max_duration": 16.7,
    },
}
eval_params = {
    "data_layer_params": {
        "dataset_files": [os.path.join(_DATA, "librivox-dev-clean.csv")],
        "shuffle": False,
    },
}
