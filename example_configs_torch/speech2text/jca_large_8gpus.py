"""Joint CTC-attention on LibriSpeech for the PyTorch port: the twin of
``example_configs/speech2text/jca_large_8gpus.py``, key for key
(reference `example_configs/speech2text/jca_large_8gpus.py`): the LAS
conv listener (16 convs up to 768 channels, no recurrent layer), a CTC
head and a location-sensitive attention head trained together with
``MultiTaskCTCEntropyLoss`` (lambda 0.25), fp32; the attention head's
beam-4 decode is the transcript. Its CTC half runs on kernels B1a and
B1b (``ops/ctc_cuda.py``).

  LIBRISPEECH_DIR=<dir> python -m openseq2seq_tpu_torch.run \\
      --mode=train_eval \\
      --config_file=example_configs_torch/speech2text/jca_large_8gpus.py
"""
import os

import torch

from openseq2seq_tpu_torch.data.speech2text import Speech2TextDataLayer
from openseq2seq_tpu_torch.decoders import (FullyConnectedCTCDecoder,
                                            JointCTCAttentionDecoder,
                                            ListenAttendSpellDecoder)
from openseq2seq_tpu_torch.encoders import ListenAttendSpellEncoder
from openseq2seq_tpu_torch.losses import MultiTaskCTCEntropyLoss
from openseq2seq_tpu_torch.models import Speech2Text

_DATA = os.environ.get("LIBRISPEECH_DIR", "/data/librispeech")


def _clipped_relu(x):
    return torch.clamp(torch.relu(x), max=20.0)


base_model = Speech2Text
base_params = {
    "random_seed": 0,
    "prng_impl": "rbg",  # a TPU knob of the JAX package: no effect here
    "dropout_bits": 8,
    "num_epochs": 50,
    "logdir": os.environ.get("OS2S_LOGDIR", "jca_log_folder"),
    "batch_size_per_gpu": 64,
    "save_summaries_steps": 1100,
    "print_loss_steps": 10,
    "print_samples_steps": 200,
    "eval_steps": 1100,
    "save_checkpoint_steps": 1100,

    "optimizer": "Adam",
    "optimizer_params": {},
    "lr_policy": "poly_decay",
    "lr_policy_params": {"learning_rate": 1e-3, "power": 2.0,
                         "min_lr": 1e-5, "decay_steps": 500000},
    "max_grad_norm": 1.0,
    "regularizer": "l2",
    "regularizer_params": {"scale": 1e-4},
    "dtype": "float32",

    "encoder": ListenAttendSpellEncoder,
    "encoder_params": {
        "convnet_layers": [
            {"type": "conv1d", "repeat": 1, "kernel_size": [11],
             "stride": [2], "num_channels": 256, "padding": "SAME",
             "dropout_keep_prob": 0.8},
            {"type": "conv1d", "repeat": 7, "kernel_size": [11],
             "stride": [1], "num_channels": 256, "padding": "SAME",
             "dropout_keep_prob": 0.8},
            {"type": "conv1d", "repeat": 1, "kernel_size": [11],
             "stride": [2], "num_channels": 384, "padding": "SAME",
             "dropout_keep_prob": 0.8},
            {"type": "conv1d", "repeat": 3, "kernel_size": [11],
             "stride": [1], "num_channels": 512, "padding": "SAME",
             "dropout_keep_prob": 0.8},
            {"type": "conv1d", "repeat": 4, "kernel_size": [11],
             "stride": [1], "num_channels": 768, "padding": "SAME",
             "dropout_keep_prob": 0.7},
        ],
        "recurrent_layers": [],
        "dropout_keep_prob": 0.8,
        "normalization": "batch_norm",
        "activation_fn": _clipped_relu,
    },

    "decoder": JointCTCAttentionDecoder,
    "decoder_params": {
        "attn_decoder": ListenAttendSpellDecoder,
        "attn_decoder_params": {
            "tgt_emb_size": 256,
            "pos_embedding": True,
            "attention_params": {
                "attention_dim": 256,
                "attention_type": "chorowski",
                "use_coverage": True,
                "num_heads": 1,
                "plot_attention": True,
            },
            "rnn_type": "lstm",
            "hidden_dim": 512,
            "num_layers": 1,
            "dropout_keep_prob": 0.8,
        },
        "ctc_decoder": FullyConnectedCTCDecoder,
        "ctc_decoder_params": {"use_language_model": False},
        "beam_search_params": {"beam_width": 4},
        "language_model_params": {"use_language_model": False},
        "GO_SYMBOL": 29,
        "END_SYMBOL": 30,
        "tgt_vocab_size": 31,
    },

    "loss": MultiTaskCTCEntropyLoss,
    "loss_params": {
        # read by nothing, as in the JAX package (C28)
        "seq_loss_params": {"offset_target_by_one": False,
                            "average_across_timestep": True,
                            "do_mask": True},
        "ctc_loss_params": {},
        "lambda_value": 0.25,
    },

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
        "autoregressive": True,
    },
}
eval_params = {
    "data_layer_params": {
        "dataset_files": [os.path.join(_DATA, "librivox-dev-clean.csv")],
        "shuffle": False,
    },
}
