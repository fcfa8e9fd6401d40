"""Jasper model family factory (port of ``openseq2seq_tpu/zoo/jasper.py``),
bound to the port's classes.

Jasper BxR, dense-residual variant: prologue conv (k=11, stride 2), B
residual blocks of R conv-BN-relu-dropout sub-layers, then two epilogue
convs (k=29 dilation 2, k=1); channels 256 to 1024, CTC out. The block
table and the recipe are the JAX package's; that module imports jax, so
they are restated here rather than imported.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

_BLOCKS_10x5 = [
    # (kernel, channels, dropout_keep)
    (11, 256, 0.8), (11, 256, 0.8), (13, 384, 0.8), (13, 384, 0.8),
    (17, 512, 0.8), (17, 512, 0.8), (21, 640, 0.7), (21, 640, 0.7),
    (25, 768, 0.7), (25, 768, 0.7),
]


def jasper_convnet_layers(num_blocks: int = 10, block_repeat: int = 5,
                          residual_dense: bool = True,
                          width_scale: float = 1.0) -> List[Dict[str, Any]]:
    def ch(c):
        return max(int(c * width_scale) // 8 * 8, 8)

    layers: List[Dict[str, Any]] = [{
        "type": "conv1d", "repeat": 1, "kernel_size": [11], "stride": [2],
        "num_channels": ch(256), "padding": "SAME", "dilation": [1],
        "dropout_keep_prob": 0.8,
    }]
    for k, c, keep in _BLOCKS_10x5[:num_blocks]:
        layers.append({
            "type": "conv1d", "repeat": block_repeat, "kernel_size": [k],
            "stride": [1], "num_channels": ch(c), "padding": "SAME",
            "dilation": [1], "dropout_keep_prob": keep,
            "residual": True, "residual_dense": residual_dense,
        })
    layers.append({
        "type": "conv1d", "repeat": 1, "kernel_size": [29], "stride": [1],
        "num_channels": ch(896), "padding": "SAME", "dilation": [2],
        "dropout_keep_prob": 0.6,
    })
    layers.append({
        "type": "conv1d", "repeat": 1, "kernel_size": [1], "stride": [1],
        "num_channels": ch(1024), "padding": "SAME", "dilation": [1],
        "dropout_keep_prob": 0.6,
    })
    return layers


def jasper_model_params(data_layer, data_layer_params: Dict[str, Any],
                        num_blocks: int = 10, block_repeat: int = 5,
                        batch_size_per_gpu: int = 32,
                        dtype: str = "mixed",
                        width_scale: float = 1.0,
                        **overrides) -> Dict[str, Any]:
    """Speech2Text base_params for Jasper BxR, the JAX package's recipe
    (NovoGrad + LARC + poly_decay, ``dropout_bits: 8``) with the
    port's encoder, decoder and loss. ``use_pallas`` puts the CTC
    recursion on the hand-written CUDA kernel."""
    from ..decoders import FullyConnectedCTCDecoder
    from ..encoders import TDNNEncoder
    from ..losses import CTCLoss

    params = {
        "random_seed": 0,
        "batch_size_per_gpu": batch_size_per_gpu,
        "save_summaries_steps": None,
        "print_loss_steps": 10,
        "print_samples_steps": None,
        "eval_steps": 2200,
        "save_checkpoint_steps": None,
        "optimizer": "NovoGrad",
        "optimizer_params": {
            "beta1": 0.95, "beta2": 0.98, "epsilon": 1e-8,
            "weight_decay": 0.001, "grad_averaging": False,
        },
        "lr_policy": "poly_decay",
        "lr_policy_params": {
            "learning_rate": 0.02, "min_lr": 1e-5, "power": 2.0,
            "decay_steps": 100000,
        },
        "larc_params": {"larc_eta": 0.001},
        "dtype": dtype,
        "encoder": TDNNEncoder,
        "encoder_params": {
            "convnet_layers": jasper_convnet_layers(
                num_blocks, block_repeat, width_scale=width_scale),
            "dropout_keep_prob": 0.7,
            "initializer": "xavier_normal",
            "normalization": "batch_norm",
            "activation_fn": torch.relu,
            "use_conv_mask": True,
        },
        "decoder": FullyConnectedCTCDecoder,
        "decoder_params": {"use_language_model": False,
                           "initializer": "xavier_uniform"},
        "loss": CTCLoss,
        "loss_params": {"use_pallas": True},
        "prng_impl": "rbg",
        "dropout_bits": 8,
        "data_layer": data_layer,
        "data_layer_params": data_layer_params,
    }
    params.update(overrides)
    return params
