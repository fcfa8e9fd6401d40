"""A tiny ResNet v2 (two bottleneck stages of width 8, a 3x3 first conv
and the SAME max pool) on small synthetic batches (4 x 16 x 16 x 3, 10
classes), fp32: the port's image training, eval and infer on the CPU in
seconds, e.g.

    python -m openseq2seq_tpu_torch.run --mode=train_eval --device=cpu \\
        --logdir=<dir> \\
        --config_file=example_configs_torch/image2label/resnet_tiny_synthetic.py

The synthetic layer repeats one batch, so the loss falls within the 20
steps.
"""
from openseq2seq_tpu_torch.data.synthetic import SyntheticImageDataLayer
from openseq2seq_tpu_torch.decoders import FullyConnectedDecoder
from openseq2seq_tpu_torch.encoders import ResNetEncoder
from openseq2seq_tpu_torch.losses import CrossEntropyLoss
from openseq2seq_tpu_torch.models import Image2Label

base_model = Image2Label
base_params = {
    "random_seed": 0,
    "max_steps": 20,
    "logdir": "resnet_tiny_synthetic_logs",
    "batch_size_per_gpu": 4,
    "print_loss_steps": 5,
    "save_checkpoint_steps": 10,
    "eval_steps": 10,
    "optimizer": "NovoGrad",
    "optimizer_params": {"beta1": 0.95, "beta2": 0.98, "epsilon": 1e-8,
                         "weight_decay": 0.001, "grad_averaging": False},
    "lr_policy": "poly_decay",
    "lr_policy_params": {"learning_rate": 0.02, "power": 2.0},
    "dtype": "float32",
    "encoder": ResNetEncoder,
    "encoder_params": {"resnet_size": 50, "version": 2,
                       "block_sizes": [1, 1], "block_strides": [1, 2],
                       "first_num_filters": 8, "first_kernel_size": 3},
    "decoder": FullyConnectedDecoder,
    "decoder_params": {"output_dim": 10},
    "loss": CrossEntropyLoss,
    "loss_params": {},
    "data_layer": SyntheticImageDataLayer,
    "data_layer_params": {"num_classes": 10, "image_size": 16,
                          "num_batches": 2},
}
