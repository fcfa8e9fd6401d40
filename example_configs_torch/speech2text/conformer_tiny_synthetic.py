# Conformer cut to two blocks of width 128 (4 heads, depthwise kernel 7),
# fp32, on small synthetic batches (4 x 40 frames x 16 features, 10 frames
# after the 4x subsampling, 6-label transcripts): the port's Conformer
# training, eval and infer on the CPU in seconds, never timed, e.g.
#
#   python -m openseq2seq_tpu_torch.run --mode=train_eval --device=cpu \
#       --logdir=<dir> \
#       --config_file=example_configs_torch/speech2text/conformer_tiny_synthetic.py
#
# Both kernel flags are on, so the CPU runs the kernels' plain versions,
# forward and backward (and the card the kernels); the width is 128 so
# that the JAX package's fused conv module takes its kernel path too
# (conformer_pallas.supported wants D % 128 == 0). Training is Conformer-M's
# setup (AdamW, transformer_policy, clipping at 5, dropout 0.1) with the
# warmup cut to 20 steps.
from openseq2seq_tpu_torch.data.synthetic import SyntheticSpeechDataLayer
from openseq2seq_tpu_torch.decoders import FullyConnectedCTCDecoder
from openseq2seq_tpu_torch.encoders import ConformerEncoder
from openseq2seq_tpu_torch.losses import CTCLoss
from openseq2seq_tpu_torch.models import Speech2Text

base_model = Speech2Text

base_params = {
    "random_seed": 0,
    "logdir": "conformer_tiny_synthetic_logs",
    "batch_size_per_gpu": 4,
    "dtype": "float32",
    "optimizer": "AdamW",
    "optimizer_params": {"learning_rate": 0.5, "beta1": 0.9, "beta2": 0.98,
                         "epsilon": 1e-9, "weight_decay": 1e-6},
    "lr_policy": "transformer_policy",
    "lr_policy_params": {"learning_rate": 0.5, "d_model": 128,
                         "warmup_steps": 20},
    "max_grad_norm": 5.0,
    # in base_params, not train_params, so that --max_steps can override
    # them
    "max_steps": 20,
    "print_loss_steps": 5,
    "save_checkpoint_steps": 10,
    "eval_steps": 10,
    "encoder": ConformerEncoder,
    "encoder_params": {
        "num_layers": 2,
        "hidden_size": 128,
        "num_heads": 4,
        "conv_kernel_size": 7,
        "ffn_expansion": 4,
        "conv_norm": "layer_norm",
        "flash_attention": True,
        "fused_conv_module": True,
    },
    "decoder": FullyConnectedCTCDecoder,
    "decoder_params": {"use_language_model": False},
    "loss": CTCLoss,
    "loss_params": {"use_pallas": True},
    "data_layer": SyntheticSpeechDataLayer,
    "data_layer_params": {
        "num_audio_features": 16,
        "tgt_vocab_size": 29,
        "time_steps": 40,
        "label_length": 6,
        "num_batches": 2,
    },
}
