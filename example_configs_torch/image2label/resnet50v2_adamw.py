"""ResNet-50 v2 on ImageNet with AdamW (reference
`example_configs/image2label/resnet-50v2-adamw.py`; top-1 target 76.36
@ 100 epochs, BASELINE.md).

The PyTorch port's twin of
``example_configs/image2label/resnet50v2_adamw.py``, key for key."""
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
    "logdir": os.environ.get("OS2S_LOGDIR", "resnet50_adamw_log"),
    "batch_size_per_gpu": 128,
    "print_loss_steps": 100,
    "save_summaries_steps": 500,
    "eval_steps": 5000,
    "save_checkpoint_steps": 5000,
    "num_checkpoints": 3,

    "optimizer": "AdamW",
    "optimizer_params": {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
                         "weight_decay": 0.1},
    "lr_policy": "cosine_decay",
    "lr_policy_params": {"learning_rate": 0.002, "warmup_steps": 5000,
                         "decay_steps": 1000000, "min_lr": 0.0},
    "dtype": "mixed",

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
