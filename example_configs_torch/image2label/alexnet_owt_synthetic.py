"""AlexNet (one-weird-trick) at ``alexnet_owt.py``'s width on synthetic
batches: the recipe's network, optimizer and "mixed" policy, 227 x 227 x 3
images, batch 256, 1,000 classes; the synthetic layer repeats one batch.

    python -m openseq2seq_tpu_torch.run --mode=train --logdir=<dir> \\
        --config_file=example_configs_torch/image2label/alexnet_owt_synthetic.py
"""
from openseq2seq_tpu_torch.data.synthetic import SyntheticImageDataLayer
from openseq2seq_tpu_torch.decoders import FullyConnectedDecoder
from openseq2seq_tpu_torch.encoders import CNNEncoder
from openseq2seq_tpu_torch.losses import CrossEntropyLoss
from openseq2seq_tpu_torch.models import Image2Label

base_model = Image2Label
base_params = {
    "random_seed": 0,
    "max_steps": 600000,
    "logdir": "alexnet_owt_synthetic_logs",
    "batch_size_per_gpu": 256,
    "print_loss_steps": 4,
    "save_checkpoint_steps": 1000,

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
    "data_layer": SyntheticImageDataLayer,
    "data_layer_params": {"num_classes": 1000, "image_size": 227,
                          "num_batches": 4},
}
