"""Listen-Attend-Spell on LibriSpeech for the PyTorch port: the twin of
``example_configs/speech2text/las_large_8gpus.py``, key for key (a
conv + BiLSTM listener, a location-sensitive attention speller; bf16
"mixed"; batches of 64), read from wav files:

  LIBRISPEECH_DIR=<dir> python -m openseq2seq_tpu_torch.run \\
      --mode=train_eval \\
      --config_file=example_configs_torch/speech2text/las_large_8gpus.py

``LIBRISPEECH_DIR`` holds the LibriSpeech CSVs and ``vocab.txt``
(``openseq2seq_tpu_torch/test_utils/fake_librispeech.py`` writes a corpus
of that layout). Like the JAX recipe it leaves ``fused_rnn`` unset, so
the listener's LSTMs run the scan; ``las_large_librispeech.py`` sets it.
"""
import os

from openseq2seq_tpu_torch.data.speech2text import Speech2TextDataLayer
from openseq2seq_tpu_torch.decoders import ListenAttendSpellDecoder
from openseq2seq_tpu_torch.encoders import ListenAttendSpellEncoder
from openseq2seq_tpu_torch.losses import BasicSequenceLoss
from openseq2seq_tpu_torch.models import Speech2Text

_DATA = os.environ.get("LIBRISPEECH_DIR", "/data/librispeech")

base_model = Speech2Text
base_params = {
    "random_seed": 0,
    "prng_impl": "rbg",  # a TPU knob of the JAX package: no effect here
    "dropout_bits": 8,
    "num_epochs": 50,
    "logdir": os.environ.get("OS2S_LOGDIR", "las_log_folder"),
    "batch_size_per_gpu": 64,
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
    "dtype": "mixed",

    "encoder": ListenAttendSpellEncoder,
    "encoder_params": {
        "convnet_layers": [
            {"type": "conv1d", "repeat": 1, "kernel_size": [11],
             "stride": [2], "num_channels": 256, "padding": "SAME",
             "dropout_keep_prob": 0.8},
            {"type": "conv1d", "repeat": 3, "kernel_size": [11],
             "stride": [1], "num_channels": 384, "padding": "SAME",
             "dropout_keep_prob": 0.8},
        ],
        "recurrent_layers": [
            {"type": "lstm", "num_units": 512, "pool": 2},
            {"type": "lstm", "num_units": 512, "pool": 2},
            {"type": "lstm", "num_units": 512},
        ],
        "dropout_keep_prob": 0.8,
        "activation_fn": "relu",
    },

    "decoder": ListenAttendSpellDecoder,
    "decoder_params": {
        "GO_SYMBOL": 29,
        "END_SYMBOL": 30,
        "tgt_emb_size": 256,
        "attention_params": {
            "attention_dim": 256,
            "attention_type": "chorowski",
            "use_coverage": True,
            "num_heads": 1,
            "plot_attention": True,
        },
        "rnn_type": "lstm",
        "hidden_dim": 512,
        "num_layers": 2,
        "dropout_keep_prob": 0.8,
        "beam_width": 4,
    },

    "loss": BasicSequenceLoss,
    # the decoder feeds y[:, :-1] and emits T - 1 logits predicting y[1:],
    # so the loss shifts the targets by one
    "loss_params": {"offset_target_by_one": True,
                    "average_across_timestep": True,
                    "do_mask": True},

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
