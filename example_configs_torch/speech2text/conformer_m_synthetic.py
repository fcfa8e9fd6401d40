# Conformer-M CTC at full published width on synthetic speech, for the
# PyTorch port's training, eval and infer:
#
#   python -m openseq2seq_tpu_torch.run --mode=train --logdir=<dir> \
#       --config_file=example_configs_torch/speech2text/conformer_m_synthetic.py
#
# (and --mode=eval, --mode=infer from a checkpoint in <dir>). The model is
# the repository's Conformer bench (scripts/bench_conformer.py:51-108 with
# BENCH_FLASH=1 BENCH_FUSED=1; Gulati et al. 2020, table 1): 16 blocks of
# width 256 with 4 heads, depthwise kernel 31, FFN x4, 64 front-end
# channels (d / 4); bf16 compute from fp32 params ("mixed"); dropout 0.1
# with 8-bit masks; AdamW with transformer_policy (10,000 warmup steps)
# and gradient clipping at 5. With `flash_attention` each block's
# relative-position attention runs on the hand-written kernels
# csrc/flash_relpos_fwd.cu and csrc/flash_relpos_bwd.cu, and with
# `fused_conv_module` its convolution module on csrc/conformer_conv_fwd.cu
# and csrc/conformer_conv_bwd.cu: per batch (B 64, 250 frames after the
# 4x subsampling) 16 launches of each forward and, in training, 16 of each
# backward (the attention's dq and dkv kernels 16 times each); the CTC
# loss on csrc/ctc_alpha_fwd.cu (and csrc/ctc_beta_bwd.cu in training)
# once. Data: 4 synthetic batches of 64 x 1000 frames x 80 features with
# 160-label transcripts over 29 symbols; 20 training steps.
from openseq2seq_tpu_torch.data.synthetic import SyntheticSpeechDataLayer
from openseq2seq_tpu_torch.decoders import FullyConnectedCTCDecoder
from openseq2seq_tpu_torch.encoders import ConformerEncoder
from openseq2seq_tpu_torch.losses import CTCLoss
from openseq2seq_tpu_torch.models import Speech2Text

base_model = Speech2Text

base_params = {
    "random_seed": 0,
    "logdir": "conformer_m_synthetic_logs",
    "batch_size_per_gpu": 64,
    "optimizer": "AdamW",
    "optimizer_params": {"learning_rate": 2.0, "beta1": 0.9, "beta2": 0.98,
                         "epsilon": 1e-9, "weight_decay": 1e-6},
    "lr_policy": "transformer_policy",
    "lr_policy_params": {"learning_rate": 2.0, "d_model": 256,
                         "warmup_steps": 10000},
    "max_grad_norm": 5.0,
    "dtype": "mixed",
    "prng_impl": "rbg",
    "dropout_bits": 8,
    "encoder": ConformerEncoder,
    "encoder_params": {
        "num_layers": 16,
        "hidden_size": 256,
        "num_heads": 4,
        "conv_kernel_size": 31,
        "ffn_expansion": 4,
        "dropout_keep_prob": 0.9,
        "attention_dropout_keep_prob": 0.9,
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
        "num_audio_features": 80,
        "tgt_vocab_size": 29,
        "time_steps": 1000,
        "label_length": 160,
        "num_batches": 4,
    },
}

train_params = {
    "max_steps": 20,
    "print_loss_steps": 1,
    "save_checkpoint_steps": 20,
}
