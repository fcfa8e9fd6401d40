"""CIFAR-10 CNN (reference `example_configs/image2label/cifar-nv.py`).

The PyTorch port's twin of
``example_configs/image2label/cifar10_nv.py``, key for key."""
import os

from openseq2seq_tpu_torch.data.image2label import CifarDataLayer
from openseq2seq_tpu_torch.decoders import FullyConnectedDecoder
from openseq2seq_tpu_torch.encoders import CNNEncoder
from openseq2seq_tpu_torch.losses import CrossEntropyLoss
from openseq2seq_tpu_torch.models import Image2Label

_DATA = os.environ.get("CIFAR10_DIR", "/data/cifar-10-batches-bin")

base_model = Image2Label
base_params = {
    "random_seed": 0,
    "num_epochs": 200,
    "logdir": os.environ.get("OS2S_LOGDIR", "cifar_log"),
    "batch_size_per_gpu": 32,
    "print_loss_steps": 100,
    "save_summaries_steps": 500,
    "eval_steps": 2000,
    "save_checkpoint_steps": 2000,
    "num_checkpoints": 2,
    "optimizer": "Momentum",
    "optimizer_params": {"learning_rate": 0.05, "momentum": 0.9},
    "lr_policy": "poly_decay",
    "lr_policy_params": {"power": 2.0, "decay_steps": 300000},
    "dtype": "mixed",
    "regularizer": "l2",
    "regularizer_params": {"scale": 1e-4},
    "encoder": CNNEncoder,
    "encoder_params": {
        "cnn_layers": [
            {"type": "conv2d", "filters": 128, "kernel_size": 3,
             "strides": 1, "activation": "relu"},
            {"type": "conv2d", "filters": 128, "kernel_size": 3,
             "strides": 1, "activation": "relu"},
            {"type": "max_pool", "pool_size": 2},
            {"type": "conv2d", "filters": 256, "kernel_size": 3,
             "strides": 1, "activation": "relu"},
            {"type": "conv2d", "filters": 256, "kernel_size": 3,
             "strides": 1, "activation": "relu"},
            {"type": "max_pool", "pool_size": 2},
        ],
        "fc_layers": [
            {"type": "dense", "units": 512, "activation": "relu"},
            {"type": "dropout", "rate": 0.5},
        ],
    },
    "decoder": FullyConnectedDecoder,
    "decoder_params": {"output_dim": 10},
    "loss": CrossEntropyLoss,
    "loss_params": {},
    "data_layer": CifarDataLayer,
    "data_layer_params": {"data_dir": _DATA},
}
eval_params = {"data_layer_params": {"shuffle": False}}
