"""AlexNet (one-weird-trick variant) on ImageNet via the generic CNN
encoder (reference `example_configs/image2label/alexnet_owt.py`).

The PyTorch port's twin of
``example_configs/image2label/alexnet_owt.py``, key for key."""
import os

from openseq2seq_tpu_torch.data.image2label import ImagenetDataLayer
from openseq2seq_tpu_torch.decoders import FullyConnectedDecoder
from openseq2seq_tpu_torch.encoders import CNNEncoder
from openseq2seq_tpu_torch.losses import CrossEntropyLoss
from openseq2seq_tpu_torch.models import Image2Label

_DATA = os.environ.get("IMAGENET_DIR", "/data/imagenet")

base_model = Image2Label
base_params = {
    "random_seed": 0,
    "num_epochs": 120,
    "logdir": os.environ.get("OS2S_LOGDIR", "alexnet_log_folder"),
    "batch_size_per_gpu": 256,
    "print_loss_steps": 100,
    "save_summaries_steps": 500,
    "eval_steps": 5000,
    "save_checkpoint_steps": 5000,

    "optimizer": "Momentum",
    "optimizer_params": {"learning_rate": 0.04, "momentum": 0.9},
    "lr_policy": "poly_decay",
    "lr_policy_params": {"learning_rate": 0.04, "power": 1.0,
                         "decay_steps": 600000},
    "dtype": "mixed",
    "regularizer": "l2",
    "regularizer_params": {"scale": 5e-4},

    "encoder": CNNEncoder,
    "encoder_params": {
        "cnn_layers": [
            {"type": "conv2d", "filters": 64, "kernel_size": 11,
             "strides": 4, "padding": "VALID", "activation": "relu"},
            {"type": "max_pool", "pool_size": 3, "strides": 2},
            {"type": "conv2d", "filters": 192, "kernel_size": 5,
             "strides": 1, "padding": "SAME", "activation": "relu"},
            {"type": "max_pool", "pool_size": 3, "strides": 2},
            {"type": "conv2d", "filters": 384, "kernel_size": 3,
             "strides": 1, "padding": "SAME", "activation": "relu"},
            {"type": "conv2d", "filters": 256, "kernel_size": 3,
             "strides": 1, "padding": "SAME", "activation": "relu"},
            {"type": "conv2d", "filters": 256, "kernel_size": 3,
             "strides": 1, "padding": "SAME", "activation": "relu"},
            {"type": "max_pool", "pool_size": 3, "strides": 2},
        ],
        "fc_layers": [
            {"type": "dense", "units": 4096, "activation": "relu"},
            {"type": "dropout", "rate": 0.5},
            {"type": "dense", "units": 4096, "activation": "relu"},
            {"type": "dropout", "rate": 0.5},
        ],
    },
    "decoder": FullyConnectedDecoder,
    "decoder_params": {"output_dim": 1000},
    "loss": CrossEntropyLoss,
    "loss_params": {},
    "data_layer": ImagenetDataLayer,
    "data_layer_params": {
        "data_dir": _DATA,
        "image_size": 227,
        "num_classes": 1000,
    },
}
eval_params = {"data_layer_params": {"shuffle": False}}
