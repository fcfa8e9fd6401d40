"""Conformer-Transducer (RNN-T, M-scale) on LibriSpeech, for the PyTorch
port: the twin of ``example_configs/speech2text/
conformer_transducer_LibriSpeech.py``, key for key, at full width, read
from wav files by the port's ``Speech2TextDataLayer``:

  LIBRISPEECH_DIR=<dir> python -m openseq2seq_tpu_torch.run \\
      --mode=train \\
      --config_file=example_configs_torch/speech2text/conformer_transducer_librispeech.py

The encoder is Conformer-M (16 blocks of width 256, 4 heads, depthwise
kernel 31); the decoder an LSTM prediction network and additive joint of
width 320 (``decoders/transducer_decoder.py``), trained with the
diagonal-fused transducer loss with FastEmit at 0.004 and decoded greedily
(beam and shallow fusion through ``--decoder_params/beam_width`` and the
``lm_fusion_*`` keys). With `flash_attention` and `fused_conv_module`, as
``conformer_m_synthetic.py`` sets them, each block runs on the rel-pos
flash and conv module kernels. `remat` and `prng_impl` are keys with no
effect here.

``LIBRISPEECH_DIR`` holds the LibriSpeech CSVs
(wav_filename,wav_filesize,transcript) and the 28-char ``vocab.txt``;
``openseq2seq_tpu_torch/test_utils/fake_librispeech.py`` writes a corpus
of that layout and those shapes (add ``librivox-test-clean.csv`` for
infer).
"""
import os

from openseq2seq_tpu_torch.data.speech2text import Speech2TextDataLayer
from openseq2seq_tpu_torch.decoders import TransducerDecoder
from openseq2seq_tpu_torch.encoders import ConformerEncoder
from openseq2seq_tpu_torch.losses import TransducerLoss
from openseq2seq_tpu_torch.models import Speech2Text

_DATA = os.environ.get("LIBRISPEECH_DIR", "/data/librispeech")

base_model = Speech2Text

base_params = {
    "random_seed": 0,
    "num_epochs": 100,
    "logdir": os.environ.get("OS2S_LOGDIR", "conformer_rnnt_log_folder"),
    "batch_size_per_gpu": 128,
    "save_summaries_steps": 100,
    "print_loss_steps": 10,
    "print_samples_steps": 2200,
    "eval_steps": 2200,
    "save_checkpoint_steps": 1100,
    "num_checkpoints": 2,

    "optimizer": "AdamW",
    "optimizer_params": {
        "learning_rate": 2.0, "beta1": 0.9, "beta2": 0.98,
        "epsilon": 1e-9, "weight_decay": 1e-6,
    },
    "lr_policy": "transformer_policy",
    "lr_policy_params": {"learning_rate": 2.0, "d_model": 256,
                         "warmup_steps": 10000},
    "dtype": "mixed",
    "max_grad_norm": 5.0,
    "prng_impl": "rbg",
    "dropout_bits": 8,
    "remat": "blocks",

    "encoder": ConformerEncoder,
    "encoder_params": {
        "num_layers": 16,
        "hidden_size": 256,
        "num_heads": 4,
        "conv_kernel_size": 31,
        "ffn_expansion": 4,
        "dropout_keep_prob": 0.9,
        "attention_dropout_keep_prob": 0.9,
        "conv_norm": "layer_norm",
        "flash_attention": True,
        "fused_conv_module": True,
    },
    "decoder": TransducerDecoder,
    "decoder_params": {
        "pred_embed_size": 320,
        "pred_units": 320,
        "pred_layers": 1,
        "joint_dim": 320,
        "dropout_keep_prob": 0.9,
        "max_symbols_per_frame": 3,
        "fused_loss": True,
    },
    "loss": TransducerLoss,
    "loss_params": {"fastemit_lambda": 0.004},

    "data_layer": Speech2TextDataLayer,
    "data_layer_params": {
        "num_audio_features": 80,
        "input_type": "logfbank",
        "vocab_file": os.path.join(_DATA, "vocab.txt"),
        "dataset_files": [
            os.path.join(_DATA, "librivox-train-clean-100.csv"),
            os.path.join(_DATA, "librivox-train-clean-360.csv"),
            os.path.join(_DATA, "librivox-train-other-500.csv"),
        ],
        "norm_per_feature": True,
        "window": "hanning",
        "precompute_mel_basis": True,
        "sample_freq": 16000,
        "pad_to": 16,
        "dither": 1e-5,
        "max_duration": 16.7,
        "cache_features": True,
        "augmentation": {
            "n_freq_mask": 2, "n_time_mask": 10,
            "width_freq_mask": 27, "width_time_mask": 5,
        },
    },
}

train_params = {"data_layer_params": {"shuffle": True}}

eval_params = {
    "batch_size_per_gpu": 32,
    "data_layer_params": {
        "dataset_files": [os.path.join(_DATA, "librivox-dev-clean.csv")],
        "shuffle": False,
        "augmentation": {},
    },
}

infer_params = {
    "batch_size_per_gpu": 32,
    "data_layer_params": {
        "dataset_files": [os.path.join(_DATA, "librivox-test-clean.csv")],
        "shuffle": False,
        "augmentation": {},
    },
}
