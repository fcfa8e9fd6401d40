"""Toy Conformer-Transducer (RNN-T) config on the synthetic speech set,
for the PyTorch port: the twin of
``example_configs/speech2text/conformer_transducer_toy.py``, key for key.
It sets neither kernel flag, so it takes the plain attention and conv
module, as the JAX toy does.

Run:
  python -m openseq2seq_tpu_torch.run --mode=train_eval --device=cpu \\
      --config_file=example_configs_torch/speech2text/conformer_transducer_toy.py
"""
import os
import tempfile

from openseq2seq_tpu_torch.data.speech2text import Speech2TextDataLayer
from openseq2seq_tpu_torch.decoders import TransducerDecoder
from openseq2seq_tpu_torch.encoders import ConformerEncoder
from openseq2seq_tpu_torch.losses import TransducerLoss
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
    "num_epochs": 200,
    "logdir": os.environ.get("OS2S_TOY_LOGDIR", os.path.join(
        tempfile.gettempdir(), "os2s_torch_conformer_rnnt_toy_logs")),
    "batch_size_per_gpu": 10,
    "save_summaries_steps": None,
    "print_loss_steps": 20,
    "print_samples_steps": None,
    "eval_steps": 100,
    "save_checkpoint_steps": 200,
    "num_checkpoints": 2,

    "optimizer": "Adam",
    "optimizer_params": {"learning_rate": 1e-3},
    "lr_policy": "poly_decay",
    "lr_policy_params": {"power": 0.5, "decay_steps": 10000},
    "dtype": "float32",
    "max_grad_norm": 5.0,

    "encoder": ConformerEncoder,
    "encoder_params": {
        "num_layers": 2,
        "hidden_size": 64,
        "num_heads": 4,
        "conv_kernel_size": 15,
        "ffn_expansion": 2,
        "dropout_keep_prob": 1.0,
    },
    "decoder": TransducerDecoder,
    "decoder_params": {
        "pred_embed_size": 64,
        "pred_units": 64,
        "pred_layers": 1,
        "joint_dim": 64,
        "beam_width": 1,   # --decoder_params/beam_width=8 for the beam
        "fused_loss": False,  # --decoder_params/fused_loss=True
    },
    "loss": TransducerLoss,
    "loss_params": {"fastemit_lambda": 0.0},

    "data_layer": Speech2TextDataLayer,
    "data_layer_params": {
        "num_audio_features": 40,
        "input_type": "logfbank",
        "vocab_file": _VOCAB,
        "dataset_files": [_CSV],
        "shuffle": True,
        "pad_to": 16,
        "norm_per_feature": True,
        "window": "hanning",
        "precompute_mel_basis": True,
        "sample_freq": 16000,
    },
}

train_params = {}

eval_params = {
    "batch_size_per_gpu": 10,
    "data_layer_params": {"shuffle": False},
}

infer_params = {
    "batch_size_per_gpu": 10,
    "data_layer_params": {"shuffle": False},
}
