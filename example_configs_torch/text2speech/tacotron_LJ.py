"""Tacotron-2 on LJSpeech, for the PyTorch port: the twin of
``example_configs/text2speech/tacotron_LJ.py``, key for key. It reads the
corpus from ``LJSPEECH_DIR`` (``metadata.csv``, ``vocab_tts.txt`` and
``wavs/``), which is not in the repository.

Run:
  LJSPEECH_DIR=<dir> python -m openseq2seq_tpu_torch.run --mode=train_eval \
      --config_file=example_configs_torch/text2speech/tacotron_LJ.py
"""
import os

from openseq2seq_tpu_torch.data.text2speech import Text2SpeechDataLayer
from openseq2seq_tpu_torch.decoders import Tacotron2Decoder
from openseq2seq_tpu_torch.encoders import Tacotron2Encoder
from openseq2seq_tpu_torch.losses import Text2SpeechLoss
from openseq2seq_tpu_torch.models import Text2SpeechTacotron

_DATA = os.environ.get("LJSPEECH_DIR", "/data/LJSpeech-1.1")

base_model = Text2SpeechTacotron
base_params = {
    "random_seed": 0,
    "num_epochs": 500,
    "logdir": os.environ.get("OS2S_LOGDIR", "tacotron_log_folder"),
    "batch_size_per_gpu": 48,
    "print_loss_steps": 50,
    "save_summaries_steps": 50,
    "eval_steps": 500,
    "save_checkpoint_steps": 2500,
    "num_checkpoints": 3,

    "optimizer": "Adam",
    "optimizer_params": {"learning_rate": 1e-3},
    "lr_policy": "exp_decay",
    "lr_policy_params": {
        "decay_steps": 20000, "decay_rate": 0.1,
        "use_staircase_decay": False, "begin_decay_at": 45000,
        "min_lr": 1e-5,
    },
    "dtype": "mixed",
    "max_grad_norm": 1.0,
    "regularizer": "l2",
    "regularizer_params": {"scale": 1e-6},

    "encoder": Tacotron2Encoder,
    "encoder_params": {
        "cnn_dropout_prob": 0.5,
        "rnn_dropout_prob": 0.1,
        "src_emb_size": 512,
        "conv_layers": [
            {"kernel_size": [5], "stride": [1], "num_channels": 512,
             "padding": "SAME"},
            {"kernel_size": [5], "stride": [1], "num_channels": 512,
             "padding": "SAME"},
            {"kernel_size": [5], "stride": [1], "num_channels": 512,
             "padding": "SAME"},
        ],
        "activation_fn": "relu",
        "num_rnn_layers": 1,
        "rnn_cell_dim": 256,
        "use_cudnn_rnn": True,
        "rnn_type": "lstm",
        "rnn_unidirectional": False,
        "zoneout_prob": 0.1,
    },
    "decoder": Tacotron2Decoder,
    "decoder_params": {
        "attention_layer_size": 128,
        "attention_type": "location",
        "decoder_cell_units": 1024,
        "decoder_cell_type": "lstm",
        "decoder_layers": 2,
        "enable_prenet": True,
        "prenet_layers": 2,
        "prenet_units": 256,
        "enable_postnet": True,
        "zoneout_prob": 0.1,
        "dropout_prob": 0.1,
        "mask_decoder_sequence": True,
        "infer_max_steps": 1000,
    },
    "loss": Text2SpeechLoss,
    "loss_params": {"use_mask": True},
    "data_layer": Text2SpeechDataLayer,
    "data_layer_params": {
        "dataset": "LJ",
        "dataset_location": _DATA,
        "num_audio_features": 80,
        "output_type": "mel",
        "vocab_file": os.path.join(_DATA, "vocab_tts.txt"),
        "dataset_files": [os.path.join(_DATA, "metadata.csv")],
        "feature_normalize": False,
        "n_fft": 1024,
        "sample_freq": 22050,
        "pad_EOS": True,
        "duration_max": 1024,
        "trim": True,
    },
}
train_params = {"data_layer_params": {"shuffle": True}}
eval_params = {"data_layer_params": {"shuffle": False,
                                     "n_samples_eval": 32}}
infer_params = {"data_layer_params": {"shuffle": False}}
