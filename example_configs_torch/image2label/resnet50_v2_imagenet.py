"""ResNet-50 v2 on ImageNet with NovoGrad — faithful to the reference
(`example_configs/image2label/resnet-50v2-nvgrad.py`): NovoGrad(0.95,
0.98, wd 0.004, no grad averaging), poly_decay lr 0.03 power 2 over the
full run, bs128, bf16 mixed. Top-1 target 77.00 @ 100 epochs, 77.63 @
300 (BASELINE.md). The model-level initializer matches the reference's
tf.variance_scaling_initializer defaults (scale 1.0, fan_in, normal) —
that is flax's lecun_normal, the Conv/Dense default, so no override.

The PyTorch port's twin of
``example_configs/image2label/resnet50_v2_imagenet.py``, key for key."""
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
    "logdir": os.environ.get("OS2S_LOGDIR", "resnet50_log_folder"),
    "batch_size_per_gpu": 128,
    "print_loss_steps": 100,
    "save_summaries_steps": 500,
    "eval_steps": 5000,
    "save_checkpoint_steps": 5000,
    "num_checkpoints": 3,

    "optimizer": "NovoGrad",
    "optimizer_params": {"beta1": 0.95, "beta2": 0.98, "epsilon": 1e-8,
                         "weight_decay": 0.004,
                         "grad_averaging": False},
    # decay_steps defaults to the full run (models/model.py
    # _resolved_lr_policy_params, mirroring the reference)
    "lr_policy": "poly_decay",
    "lr_policy_params": {"learning_rate": 0.03, "power": 2.0},
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
