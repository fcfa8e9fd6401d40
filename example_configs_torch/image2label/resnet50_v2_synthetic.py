"""ResNet-50 v2 at ``scripts/bench_resnet.py``'s width on synthetic
batches: 224 x 224 x 3 images, batch 128, "mixed", 1,000 classes,
NovoGrad (0.95, 0.98, weight decay 0.001, no gradient averaging), lr 0.02
under ``cosine_decay`` with 5,000 warm-up steps over 1,000,000. The
synthetic layer repeats one batch (``data/synthetic.py``), so the model
can learn it. 25,557,032 parameters, the JAX model's.

    python -m openseq2seq_tpu_torch.run --mode=train --logdir=<dir> \\
        --config_file=example_configs_torch/image2label/resnet50_v2_synthetic.py
"""
from openseq2seq_tpu_torch.data.synthetic import SyntheticImageDataLayer
from openseq2seq_tpu_torch.decoders import FullyConnectedDecoder
from openseq2seq_tpu_torch.encoders import ResNetEncoder
from openseq2seq_tpu_torch.losses import CrossEntropyLoss
from openseq2seq_tpu_torch.models import Image2Label

base_model = Image2Label
base_params = {
    "random_seed": 0,
    "max_steps": 1000000,
    "logdir": "resnet50_v2_synthetic_logs",
    "batch_size_per_gpu": 128,
    "print_loss_steps": 5,
    "save_checkpoint_steps": 1000,
    "optimizer": "NovoGrad",
    "optimizer_params": {"beta1": 0.95, "beta2": 0.98, "epsilon": 1e-8,
                         "weight_decay": 0.001, "grad_averaging": False},
    "lr_policy": "cosine_decay",
    "lr_policy_params": {"learning_rate": 0.02, "warmup_steps": 5000,
                         "decay_steps": 1000000, "min_lr": 0.0},
    "dtype": "mixed",
    "encoder": ResNetEncoder,
    "encoder_params": {"resnet_size": 50, "version": 2,
                       "regularize_bn": False},
    "decoder": FullyConnectedDecoder,
    "decoder_params": {"output_dim": 1000},
    "loss": CrossEntropyLoss,
    "loss_params": {},
    "data_layer": SyntheticImageDataLayer,
    "data_layer_params": {"num_classes": 1000, "image_size": 224,
                          "num_batches": 4},
}
eval_params = {"data_layer_params": {"num_batches": 2}}
infer_params = {"data_layer_params": {"num_batches": 1}}
