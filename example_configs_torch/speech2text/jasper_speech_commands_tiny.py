"""A tiny Jasper-style keyword classifier (two conv1d blocks of width 16,
16 log filterbanks, fp32) with the speech-commands decoder
(``FullyConnectedSCDecoder``: the valid frames averaged, then one dense
layer) on labelled tone clips (``test_utils/fake_speech_commands.py``,
8 labels, written on first use under ``os2s_fake_speech_commands`` in the
temporary directory, or ``OS2S_FAKE_SC_DIR``); logs under
``OS2S_TOY_LOGDIR``. The port's speech-commands path on the CPU in
seconds:

    python -m openseq2seq_tpu_torch.run --mode=train_eval --device=cpu \\
        --config_file=example_configs_torch/speech2text/jasper_speech_commands_tiny.py
"""
import os
import tempfile

from openseq2seq_tpu_torch.data.speech2text import SpeechCommandsDataLayer
from openseq2seq_tpu_torch.decoders import FullyConnectedSCDecoder
from openseq2seq_tpu_torch.encoders import TDNNEncoder
from openseq2seq_tpu_torch.losses import CrossEntropyLoss
from openseq2seq_tpu_torch.models import Image2Label
from openseq2seq_tpu_torch.test_utils import fake_speech_commands

_DATA = os.environ.get("OS2S_FAKE_SC_DIR", os.path.join(
    tempfile.gettempdir(), "os2s_fake_speech_commands"))
if not os.path.exists(os.path.join(_DATA, "test.csv")):
    fake_speech_commands.generate(_DATA)

base_model = Image2Label
base_params = {
    "random_seed": 0,
    "max_steps": 20,
    "logdir": os.environ.get("OS2S_TOY_LOGDIR", os.path.join(
        tempfile.gettempdir(), "os2s_sc_tiny_logs")),
    "batch_size_per_gpu": 8,
    "print_loss_steps": 5,
    "eval_steps": 10,
    "save_checkpoint_steps": 10,
    "optimizer": "NovoGrad",
    "optimizer_params": {"beta1": 0.95, "beta2": 0.98,
                         "weight_decay": 0.001},
    "lr_policy": "poly_decay",
    "lr_policy_params": {"learning_rate": 0.02, "power": 2.0},
    "dtype": "float32",
    "encoder": TDNNEncoder,
    "encoder_params": {
        "convnet_layers": [
            {"type": "conv1d", "repeat": 1, "kernel_size": [11],
             "stride": [2], "num_channels": 16, "padding": "SAME",
             "dilation": [1], "dropout_keep_prob": 0.8},
            {"type": "conv1d", "repeat": 2, "kernel_size": [5],
             "stride": [1], "num_channels": 16, "padding": "SAME",
             "dilation": [1], "dropout_keep_prob": 0.8, "residual": True},
        ],
        "dropout_keep_prob": 0.8,
        "normalization": "batch_norm",
        "activation_fn": "relu",
        "use_conv_mask": True,
    },
    "decoder": FullyConnectedSCDecoder,
    "decoder_params": {"output_dim": 8},
    "loss": CrossEntropyLoss,
    "loss_params": {},
    "data_layer": SpeechCommandsDataLayer,
    "data_layer_params": {
        "dataset_files": [os.path.join(_DATA, "train.csv")],
        "dataset_location": _DATA,
        "num_audio_features": 16,
        "audio_length": 1000,
        "num_labels": 8,
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
