# QuartzNet cut to three separable blocks of up to 32 channels, fp32, on
# small synthetic batches (16 features, 41 frames, 6-label transcripts):
# the recipe's separable convs, NovoGrad and cosine decay and its CTC loss
# with ``use_pallas`` (the kernels' plain versions on the CPU), trained,
# evaluated and inferred in seconds, e.g.
#
#   python -m openseq2seq_tpu_torch.run --mode=train_eval --device=cpu \
#       --logdir=<dir> \
#       --config_file=example_configs_torch/speech2text/quartznet_tiny_synthetic.py
from openseq2seq_tpu_torch.data.synthetic import SyntheticSpeechDataLayer
from openseq2seq_tpu_torch.decoders import FullyConnectedCTCDecoder
from openseq2seq_tpu_torch.encoders import TDNNEncoder
from openseq2seq_tpu_torch.losses import CTCLoss
from openseq2seq_tpu_torch.models import Speech2Text


def _sep(k, ch, repeat, stride=1, dilation=1, residual=True):
    return {"type": "sep_conv1d", "repeat": repeat, "kernel_size": [k],
            "stride": [stride], "num_channels": ch, "padding": "SAME",
            "dilation": [dilation],
            **({"residual": True, "residual_dense": False}
               if residual else {})}


base_model = Speech2Text
base_params = {
    "random_seed": 0,
    "batch_size_per_gpu": 4,
    "logdir": "quartznet_tiny_synthetic_logs",
    # in base_params, so that --max_steps overrides them
    "max_steps": 20,
    "print_loss_steps": 5,
    "save_checkpoint_steps": 10,
    "eval_steps": 10,
    "optimizer": "NovoGrad",
    "optimizer_params": {"beta1": 0.95, "beta2": 0.5, "epsilon": 1e-8,
                         "weight_decay": 0.001, "grad_averaging": False},
    "lr_policy": "cosine_decay",
    "lr_policy_params": {"learning_rate": 0.01, "min_lr": 0.0,
                         "warmup_steps": 2, "decay_steps": 20},
    "dtype": "float32",
    "encoder": TDNNEncoder,
    "encoder_params": {
        "convnet_layers": [_sep(7, 16, 1, stride=2, residual=False),
                           _sep(9, 16, 2), _sep(11, 32, 2),
                           _sep(13, 32, 1, dilation=2, residual=False),
                           {"type": "conv1d", "repeat": 1,
                            "kernel_size": [1], "stride": [1],
                            "num_channels": 64, "padding": "SAME",
                            "dilation": [1]}],
        "dropout_keep_prob": 1.0,
        "initializer": "xavier",
        "normalization": "batch_norm",
        "activation_fn": "relu",
        "use_conv_mask": True,
    },
    "decoder": FullyConnectedCTCDecoder,
    "decoder_params": {"initializer": "xavier", "use_language_model": False},
    "loss": CTCLoss,
    "loss_params": {"use_pallas": True},
    "data_layer": SyntheticSpeechDataLayer,
    "data_layer_params": {"num_audio_features": 16, "tgt_vocab_size": 29,
                          "time_steps": 41, "label_length": 6,
                          "num_batches": 2},
}
