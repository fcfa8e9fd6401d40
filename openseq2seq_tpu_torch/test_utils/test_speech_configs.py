"""Tiny Wave2Letter-style config for convergence tests (the analogue of
the reference's `open_seq2seq/test_utils/test_speech_configs/
w2l_test_config.py`)."""
from __future__ import annotations

import torch

from ..data.speech2text import Speech2TextDataLayer
from ..decoders import FullyConnectedCTCDecoder
from ..encoders import TDNNEncoder
from ..losses import CTCLoss
from ..models import Speech2Text


def w2l_test_config(csv_path: str, vocab_path: str, logdir: str = "",
                    dtype: str = "float32", num_epochs: int = 120):
    base_params = {
        "random_seed": 0,
        "use_horovod": False,
        "num_epochs": num_epochs,
        "logdir": logdir,
        "batch_size_per_gpu": 10,
        "save_summaries_steps": None,
        "print_loss_steps": 20,
        "print_samples_steps": None,
        "eval_steps": 50,
        "save_checkpoint_steps": None,
        "data_layer": Speech2TextDataLayer,
        "data_layer_params": {
            "num_audio_features": 40,
            "input_type": "logfbank",
            "vocab_file": vocab_path,
            "dataset_files": [csv_path],
            "shuffle": True,
            "pad_to": 16,
            "norm_per_feature": True,
            "window": "hanning",
            "precompute_mel_basis": True,
            "sample_freq": 16000,
        },
        "optimizer": "Adam",
        "optimizer_params": {"learning_rate": 3e-4},
        "lr_policy": "poly_decay",
        "lr_policy_params": {"power": 0.5, "decay_steps": 10000},
        "dtype": dtype,
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
        "decoder_params": {
            "use_language_model": False,
        },
        "loss": CTCLoss,
        "loss_params": {},
    }
    eval_params = {
        "batch_size_per_gpu": 10,
        "data_layer_params": {
            "shuffle": False,
        },
    }
    return base_params, eval_params


def quartznet_test_config(csv_path: str, vocab_path: str, logdir: str = "",
                          dtype: str = "float32", num_epochs: int = 120):
    """Tiny QuartzNet-style config: depthwise-separable convs with
    residual blocks (the sep_conv1d path of the TDNN encoder, reference
    `example_configs/speech2text/quartznet15x5_LibriSpeech.py`)."""
    base_params, eval_params = w2l_test_config(
        csv_path, vocab_path, logdir=logdir, dtype=dtype,
        num_epochs=num_epochs)
    base_params["encoder_params"]["convnet_layers"] = [
        {"type": "sep_conv1d", "repeat": 1, "kernel_size": [7],
         "stride": [1], "num_channels": 64, "padding": "SAME"},
        {"type": "sep_conv1d", "repeat": 2, "kernel_size": [11],
         "stride": [1], "num_channels": 96, "padding": "SAME",
         "residual": True},
        {"type": "conv1d", "repeat": 1, "kernel_size": [1],
         "stride": [1], "num_channels": 128, "padding": "SAME"},
    ]
    return base_params, eval_params


def conformer_test_config(csv_path: str, vocab_path: str, logdir: str = "",
                          dtype: str = "float32", num_epochs: int = 120):
    """Tiny Conformer-CTC config (beyond-parity encoder — the reference
    predates the Conformer; rides the identical Speech2Text stack)."""
    base_params, eval_params = w2l_test_config(
        csv_path, vocab_path, logdir=logdir, dtype=dtype,
        num_epochs=num_epochs)
    from ..encoders import ConformerEncoder
    base_params["encoder"] = ConformerEncoder
    base_params["encoder_params"] = {
        "num_layers": 2,
        "hidden_size": 64,
        "num_heads": 4,
        "conv_kernel_size": 15,
        "ffn_expansion": 2,
        "dropout_keep_prob": 1.0,
    }
    base_params["optimizer_params"] = {"learning_rate": 1e-3}
    return base_params, eval_params


def transducer_test_config(csv_path: str, vocab_path: str, logdir: str = "",
                           dtype: str = "float32", num_epochs: int = 120):
    """Tiny Conformer-Transducer config (beyond-parity — RNN-T decoder +
    loss over the Conformer encoder; see decoders/transducer_decoder.py)."""
    base_params, eval_params = conformer_test_config(
        csv_path, vocab_path, logdir=logdir, dtype=dtype,
        num_epochs=num_epochs)
    from ..decoders import TransducerDecoder
    from ..losses import TransducerLoss
    base_params["decoder"] = TransducerDecoder
    base_params["decoder_params"] = {
        "pred_embed_size": 64,
        "pred_units": 64,
        "pred_layers": 1,
        "joint_dim": 64,
    }
    base_params["loss"] = TransducerLoss
    base_params["loss_params"] = {}
    return base_params, eval_params


def fill_derived_params(base_params):
    """Propagate data-layer-derived values (tgt_vocab_size) into the
    decoder params — the reference does this inside the data layer /
    model handshake; configs rely on it."""
    return base_params
