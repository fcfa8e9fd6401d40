"""Toy DeepSpeech2 config on the synthetic speech set, for the PyTorch
port: the twin of ``example_configs/speech2text/ds2_toy_config.py``, key
for key: conv2d + BiGRU + CTC, fp32. ``fused_rnn`` puts its GRU (B 10,
H 64) on the scan kernels (B4) in fp32 on the card, and their plain
versions on the CPU.

Run:
  python -m openseq2seq_tpu_torch.run --mode=train_eval --device=cpu \
      --config_file=example_configs_torch/speech2text/ds2_toy_config.py
"""
import os
import tempfile

import torch

from openseq2seq_tpu_torch.data.speech2text import Speech2TextDataLayer
from openseq2seq_tpu_torch.decoders import FullyConnectedCTCDecoder
from openseq2seq_tpu_torch.encoders import DeepSpeech2Encoder
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
    "fused_rnn": True,
    "num_epochs": 200,
    "logdir": os.environ.get("OS2S_TOY_LOGDIR", os.path.join(
        tempfile.gettempdir(), "os2s_torch_ds2_toy_logs")),
    "batch_size_per_gpu": 10,
    "print_loss_steps": 25,
    "eval_steps": 100,
    "save_checkpoint_steps": 100,
    "num_checkpoints": 2,

    "optimizer": "Adam",
    "optimizer_params": {"learning_rate": 5e-4},
    "lr_policy": "poly_decay",
    "lr_policy_params": {"power": 0.5, "decay_steps": 10000},
    "dtype": "float32",
    "max_grad_norm": 5.0,

    "encoder": DeepSpeech2Encoder,
    "encoder_params": {
        "conv_layers": [
            {"kernel_size": [5, 11], "stride": [2, 2],
             "num_channels": 16, "padding": "SAME"},
        ],
        "num_rnn_layers": 1,
        "rnn_cell_dim": 64,
        "use_cudnn_rnn": True,
        "rnn_type": "cudnn_gru",
        "rnn_unidirectional": False,
        "row_conv": False,
        "n_hidden": 64,
        "dropout_keep_prob": 1.0,
        "activation_fn": torch.relu,
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
        "shuffle": True,
    },
}
eval_params = {
    "data_layer_params": {"dataset_files": [_CSV], "shuffle": False},
}
infer_params = {
    "data_layer_params": {"dataset_files": [_CSV], "shuffle": False},
}
