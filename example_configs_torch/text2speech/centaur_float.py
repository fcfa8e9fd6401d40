"""Centaur on LJSpeech, for the PyTorch port: the twin of
``example_configs/text2speech/centaur_float.py``, key for key (a 256-wide
encoder of four SAME conv blocks; a 512-wide decoder of four causal conv
and attention blocks, reduction 2, windowed monotonic attention forced on
layers 1 and 3; mel and magnitude features, the decoder sized from the
mel count; fp32, NovoGrad with ``poly_decay``). It reads the corpus from
``LJSPEECH_DIR`` (``train.csv``, ``test.csv``, ``vocab_tts.txt`` and
``wavs/``), which is not in the repository;
``openseq2seq_tpu_torch/test_utils/fake_ljspeech.py`` writes a tree of
that layout. As in the JAX package, ``prenet_use_inference_dropout:
False``, ``prenet_dropout``, ``attention_layers``,
``self_attention_conv_params`` and ``mag_conv_layers`` have no effect
(C27).

Run:
  LJSPEECH_DIR=<dir> python -m openseq2seq_tpu_torch.run --mode=train_eval \
      --config_file=example_configs_torch/text2speech/centaur_float.py
"""
import os

from openseq2seq_tpu_torch.data.text2speech import Text2SpeechDataLayer
from openseq2seq_tpu_torch.decoders import CentaurDecoder
from openseq2seq_tpu_torch.encoders import CentaurEncoder
from openseq2seq_tpu_torch.losses import Text2SpeechLoss
from openseq2seq_tpu_torch.models import Text2SpeechCentaur

_DATA = os.environ.get("LJSPEECH_DIR", "/data/LJSpeech-1.1")

_HID_ENC = 256
_HID_DEC = 512


def _conv(ch, causal=False):
    return {"kernel_size": [5 if causal else 3], "stride": [1],
            "num_channels": ch,
            "padding": "CAUSAL" if causal else "SAME"}


base_model = Text2SpeechCentaur
base_params = {
    "random_seed": 0,
    "max_steps": 1000000,
    "logdir": os.environ.get("OS2S_LOGDIR", "centaur_log_folder"),
    "batch_size_per_gpu": 32,
    "print_loss_steps": 1000,
    "print_samples_steps": 1000,
    "save_summaries_steps": 1000,
    "eval_steps": 5000,
    "save_checkpoint_steps": 5000,
    "max_grad_norm": 1.0,

    "optimizer": "NovoGrad",
    "optimizer_params": {"beta1": 0.95, "beta2": 0.98, "epsilon": 1e-8,
                         "weight_decay": 0.001},
    "lr_policy": "poly_decay",
    "lr_policy_params": {"learning_rate": 0.02, "power": 2.0,
                         "decay_steps": 1000000},
    "dtype": "float32",

    "encoder": CentaurEncoder,
    "encoder_params": {
        "src_vocab_size": 94,
        "embedding_size": _HID_ENC,
        "output_size": _HID_ENC,
        "pad_embeddings_2_eight": True,
        "cnn_dropout_prob": 0.1,
        "conv_layers": [_conv(_HID_ENC)] * 4,
    },
    "decoder": CentaurDecoder,
    "decoder_params": {
        "attention_layers": 4,
        "self_attention_conv_params": _conv(_HID_DEC, causal=True),
        "window_size": 4,
        "back_step_size": 0,
        "force_layers": [1, 3],
        "hidden_size": _HID_DEC,
        "reduction_factor": 2,
        "prenet_layers": 2,
        "prenet_hidden_size": _HID_DEC,
        "prenet_use_inference_dropout": False,
        "cnn_dropout_prob": 0.1,
        "prenet_dropout": 0.5,
        "conv_layers": [_conv(_HID_DEC, causal=True)] * 4,
        "mag_conv_layers": [_conv(_HID_DEC, causal=True)] * 4,
        "attention_dropout": 0.1,
        "layer_postprocess_dropout": 0.1,
    },
    "loss": Text2SpeechLoss,
    "loss_params": {"use_mask": True, "l1_norm": True},
    "data_layer": Text2SpeechDataLayer,
    "data_layer_params": {
        "dataset": "LJ",
        "dataset_location": _DATA,
        "use_cache": True,
        "num_audio_features": {"mel": 80, "magnitude": 513},
        "output_type": "both",
        "vocab_file": os.path.join(_DATA, "vocab_tts.txt"),
        "dataset_files": [os.path.join(_DATA, "train.csv")],
        "mag_power": 1,
        "pad_EOS": True,
        "feature_normalize": False,
        "data_min": {"mel": 1e-2, "magnitude": 1e-5},
        "mel_type": "htk",
        "trim": False,
        "duration_max": 1024,
        "duration_min": 24,
        "exp_mag": True,
    },
}
eval_params = {
    "data_layer_params": {
        "dataset_files": [os.path.join(_DATA, "test.csv")],
        "shuffle": False,
    },
}
