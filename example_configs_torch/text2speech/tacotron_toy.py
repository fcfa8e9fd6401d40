"""Toy Tacotron-2 on the synthetic tone corpus, for the PyTorch port: the
twin of ``example_configs/text2speech/tacotron_toy.py`` (the smallest
end-to-end TTS run, 40 epochs of 10 tone wavs), its corpus written by the
port's ``test_utils/toy_tts.py`` on first use under ``os2s_toy_tts`` in
the temporary directory (or ``OS2S_TOY_TTS_DIR``); logs under
``OS2S_TOY_LOGDIR``. Two keys differ from the twin's: the histogram and
norm ``summaries`` are not ported and are left out, and a checkpoint is
saved every 20 steps (the twin saves none), so that eval and infer can
run from it.

Run:
  python -m openseq2seq_tpu_torch.run --mode=train_eval --device=cpu \
      --config_file=example_configs_torch/text2speech/tacotron_toy.py
"""
import os
import tempfile

from openseq2seq_tpu_torch.data.text2speech import Text2SpeechDataLayer
from openseq2seq_tpu_torch.decoders import Tacotron2Decoder
from openseq2seq_tpu_torch.encoders import Tacotron2Encoder
from openseq2seq_tpu_torch.losses import Text2SpeechLoss
from openseq2seq_tpu_torch.models import Text2SpeechTacotron
from openseq2seq_tpu_torch.test_utils import toy_tts

_DATA_DIR = os.environ.get("OS2S_TOY_TTS_DIR", os.path.join(
    tempfile.gettempdir(), "os2s_toy_tts"))
if not os.path.exists(os.path.join(_DATA_DIR, "metadata.csv")):
    toy_tts.generate(_DATA_DIR)
_CSV = os.path.join(_DATA_DIR, "metadata.csv")
_VOCAB = os.path.join(_DATA_DIR, "vocab.txt")

base_model = Text2SpeechTacotron

base_params = {
    "random_seed": 0,
    "num_epochs": 40,
    "logdir": os.environ.get("OS2S_TOY_LOGDIR", os.path.join(
        tempfile.gettempdir(), "os2s_torch_toy_tts_logs")),
    "batch_size_per_gpu": 10,
    "print_loss_steps": 10,
    "eval_steps": 20,
    "save_checkpoint_steps": 20,
    "num_checkpoints": 2,
    "save_summaries_steps": 10,

    "optimizer": "Adam",
    "optimizer_params": {"learning_rate": 1e-3},
    "max_grad_norm": 1.0,
    "dtype": "float32",

    "encoder": Tacotron2Encoder,
    "encoder_params": {
        "cnn_dropout_prob": 0.1,
        "rnn_dropout_prob": 0.1,
        "src_emb_size": 16,
        "conv_layers": [
            {"kernel_size": [5], "stride": [1], "num_channels": 16,
             "padding": "SAME"},
        ],
        "activation_fn": "relu",
        "num_rnn_layers": 1,
        "rnn_cell_dim": 16,
        "use_cudnn_rnn": False,
        "rnn_type": "lstm",
        "rnn_unidirectional": False,
    },
    "decoder": Tacotron2Decoder,
    "decoder_params": {
        "attention_layer_size": 16,
        "attention_type": "location",
        "decoder_cell_units": 32,
        "decoder_cell_type": None,
        "decoder_layers": 1,
        "enable_prenet": True,
        "prenet_layers": 1,
        "prenet_units": 16,
        "enable_postnet": True,
        "postnet_conv_layers": [
            {"kernel_size": [5], "stride": [1], "num_channels": 16,
             "padding": "SAME"},
            {"kernel_size": [5], "stride": [1], "num_channels": -1,
             "padding": "SAME"},
        ],
        "zoneout_prob": 0.1,
        "infer_max_steps": 60,
    },
    "loss": Text2SpeechLoss,
    "loss_params": {"use_mask": True},

    "data_layer": Text2SpeechDataLayer,
    "data_layer_params": {
        "dataset_location": _DATA_DIR,
        "dataset": "LJ",
        "num_audio_features": 20,
        "output_type": "mel",
        "vocab_file": _VOCAB,
        "dataset_files": [_CSV],
        "feature_normalize": False,
        "n_fft": 512,
        "sample_freq": 22050,
    },
}

train_params = {"data_layer_params": {"shuffle": True}}
eval_params = {"data_layer_params": {"shuffle": False}}
infer_params = {"data_layer_params": {"shuffle": False}}
