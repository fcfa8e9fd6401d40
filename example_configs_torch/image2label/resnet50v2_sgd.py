"""ResNet-50 v2 on ImageNet with SGD momentum (reference
`example_configs/image2label/resnet-50-v2.py`; top-1 target 76.38 @ 100
epochs, BASELINE.md).

The PyTorch port's twin of
``example_configs/image2label/resnet50v2_sgd.py``, key for key."""
import os

from openseq2seq_tpu_torch.data.image2label import ImagenetDataLayer
from openseq2seq_tpu_torch.decoders import FullyConnectedDecoder
from openseq2seq_tpu_torch.encoders import ResNetEncoder
from openseq2seq_tpu_torch.losses import CrossEntropyLoss
from openseq2seq_tpu_torch.models import Image2Label

_DATA = os.environ.get("IMAGENET_DIR", "/data/imagenet")

base_model = Image2Label
base_params = {
    "random_seed": 0,
    "num_epochs": 100,
    "logdir": os.environ.get("OS2S_LOGDIR", "resnet50_sgd_log"),
    "batch_size_per_gpu": 128,
    "print_loss_steps": 100,
    "save_summaries_steps": 500,
    "eval_steps": 5000,
    "save_checkpoint_steps": 5000,
    "num_checkpoints": 3,

    "optimizer": "Momentum",
    "optimizer_params": {"learning_rate": 0.128, "momentum": 0.9},
    "lr_policy": "piecewise_constant",
    "lr_policy_params": {
        "learning_rate": 0.128,
        # boundaries are steps at 10009 steps/epoch (bs 128, 8 chips):
        # epoch 30 / 60 / 80 / 90 of the standard recipe
        "boundaries": [300270, 600540, 800720, 900810],
        "decay_rates": [0.1, 0.01, 0.001, 1e-4],
    },
    "dtype": "mixed",
    "regularizer": "l2",
    "regularizer_params": {"scale": 1e-4},

    "encoder": ResNetEncoder,
    "encoder_params": {"resnet_size": 50, "version": 2,
                       "regularize_bn": False},
    "decoder": FullyConnectedDecoder,
    "decoder_params": {"output_dim": 1000},
    "loss": CrossEntropyLoss,
    "loss_params": {},
    "data_layer": ImagenetDataLayer,
    "data_layer_params": {
        "data_dir": _DATA,
        "image_size": 224,
        "num_classes": 1000,
    },
}
eval_params = {"data_layer_params": {"shuffle": False}}
