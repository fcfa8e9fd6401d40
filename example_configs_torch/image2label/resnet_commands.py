"""ResNet-50 classifier on Google Speech Commands mel "images"
(reference `example_configs/image2label/resnet_commands.py`;
test-accuracy targets 96.6/97.3/95.9% v1-12/v1-30/v2, BASELINE.md).

The PyTorch port's twin of
``example_configs/image2label/resnet_commands.py``, key for key."""
import os

from openseq2seq_tpu_torch.data.speech2text import SpeechCommandsDataLayer
from openseq2seq_tpu_torch.decoders import FullyConnectedDecoder
from openseq2seq_tpu_torch.encoders import ResNetEncoder
from openseq2seq_tpu_torch.losses import CrossEntropyLoss
from openseq2seq_tpu_torch.models import Image2Label

_DATA = os.environ.get("SPEECH_COMMANDS_DIR", "/data/speech_commands_v1")
NUM_LABELS = int(os.environ.get("SC_NUM_LABELS", "12"))

base_model = Image2Label
base_params = {
    "random_seed": 0,
    "num_epochs": 100,
    "logdir": os.environ.get("OS2S_LOGDIR", "resnet_commands_log"),
    "batch_size_per_gpu": 32,
    "print_loss_steps": 50,
    "save_summaries_steps": 200,
    "eval_steps": 1000,
    "save_checkpoint_steps": 1000,
    "num_checkpoints": 2,

    "optimizer": "Momentum",
    "optimizer_params": {"learning_rate": 0.2, "momentum": 0.90},
    "lr_policy": "poly_decay",
    "lr_policy_params": {"learning_rate": 0.2, "power": 2.0,
                         "decay_steps": 100000},
    "dtype": "mixed",
    "regularizer": "l2",
    "regularizer_params": {"scale": 1e-4},

    "encoder": ResNetEncoder,
    "encoder_params": {"resnet_size": 50, "version": 2,
                       "regularize_bn": False},
    "decoder": FullyConnectedDecoder,
    "decoder_params": {"output_dim": NUM_LABELS},
    "loss": CrossEntropyLoss,
    "loss_params": {},
    "data_layer": SpeechCommandsDataLayer,
    "data_layer_params": {
        "dataset_files": [os.path.join(_DATA, "train.csv")],
        "dataset_location": _DATA,
        "num_audio_features": 128,
        "audio_length": 128,
        "num_labels": NUM_LABELS,
        "model_format": "resnet",
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
