"""Jasper-style classifier on Google Speech Commands (reference
`example_configs/speech2text/jasper_commands.py`; test-accuracy targets
96.2/97.3/95.1% v1-12/v1-30/v2, BASELINE.md).

The PyTorch port's twin of
``example_configs/speech2text/jasper_speech_commands.py``, key for key."""
import os

from openseq2seq_tpu_torch.data.speech2text import SpeechCommandsDataLayer
from openseq2seq_tpu_torch.decoders import FullyConnectedDecoder
from openseq2seq_tpu_torch.encoders import TDNNEncoder
from openseq2seq_tpu_torch.losses import CrossEntropyLoss
from openseq2seq_tpu_torch.models import Image2Label

_DATA = os.environ.get("SPEECH_COMMANDS_DIR", "/data/speech_commands_v1")
NUM_LABELS = int(os.environ.get("SC_NUM_LABELS", "12"))


def _block(repeat, kernel, ch, keep):
    return {"type": "conv1d", "repeat": repeat, "kernel_size": [kernel],
            "stride": [1], "num_channels": ch, "padding": "SAME",
            "dilation": [1], "dropout_keep_prob": keep,
            "residual": True}


base_model = Image2Label
base_params = {
    "random_seed": 0,
    "prng_impl": "rbg",  # TPU-hardware dropout keys (docs/internals.md)
    "dropout_bits": 8,   # u8 threshold masks (parts/dropout.py)
    "num_epochs": 200,
    "logdir": os.environ.get("OS2S_LOGDIR", "jasper_commands_log"),
    "batch_size_per_gpu": 64,
    "print_loss_steps": 50,
    "save_summaries_steps": 200,
    "eval_steps": 1000,
    "save_checkpoint_steps": 1000,
    "num_checkpoints": 2,
    "optimizer": "NovoGrad",
    "optimizer_params": {"beta1": 0.95, "beta2": 0.98,
                         "weight_decay": 0.001},
    "lr_policy": "poly_decay",
    "lr_policy_params": {"learning_rate": 0.02, "power": 2.0,
                         "decay_steps": 100000},
    "dtype": "mixed",
    "encoder": TDNNEncoder,
    "encoder_params": {
        "convnet_layers": [
            {"type": "conv1d", "repeat": 1, "kernel_size": [11],
             "stride": [2], "num_channels": 128, "padding": "SAME",
             "dilation": [1], "dropout_keep_prob": 0.8},
            _block(3, 11, 128, 0.8),
            _block(3, 13, 192, 0.8),
            _block(3, 17, 256, 0.8),
            {"type": "conv1d", "repeat": 1, "kernel_size": [1],
             "stride": [1], "num_channels": 512, "padding": "SAME",
             "dilation": [1], "dropout_keep_prob": 0.6},
        ],
        "dropout_keep_prob": 0.7,
        "normalization": "batch_norm",
        "activation_fn": "relu",
        "use_conv_mask": True,
    },
    "decoder": FullyConnectedDecoder,
    "decoder_params": {"output_dim": NUM_LABELS},
    "loss": CrossEntropyLoss,
    "loss_params": {},
    "data_layer": SpeechCommandsDataLayer,
    "data_layer_params": {
        "dataset_files": [os.path.join(_DATA, "train.csv")],
        "dataset_location": _DATA,
        "num_audio_features": 64,
        "audio_length": 1000,
        "num_labels": NUM_LABELS,
        "model_format": "jasper",
        "augment_data": True,
    },
}
eval_params = {
    "data_layer_params": {
        "dataset_files": [os.path.join(_DATA, "test.csv")],
        "shuffle": False,
        "augment_data": False,
    },
}
