# Conformer-Transducer (RNN-T) at full width on synthetic speech, for the
# PyTorch port's training, eval and infer:
#
#   python -m openseq2seq_tpu_torch.run --mode=train --logdir=<dir> \
#       --config_file=example_configs_torch/speech2text/conformer_transducer_synthetic.py
#
# (and --mode=eval, --mode=infer from a checkpoint in <dir>). Every key of
# the repository's transducer bench (scripts/bench_transducer.py:50-103),
# uncut: the Conformer-M encoder (16 blocks of width 256, 4 heads,
# depthwise kernel 31, FFN x4, dropout 0.1), the LSTM prediction network
# (embedding, one layer and joint of width 320, dropout 0.1), at most 3
# labels a frame, the diagonal-fused transducer loss in blocks of 8
# anti-diagonals (no (B, T', U+1, V) lattice is held); AdamW at 2.0 with
# transformer_policy (d 256, 10,000 warmup steps), bf16 compute from fp32
# params ("mixed"), clipping at 5, 8-bit dropout masks. With
# `flash_attention` and `fused_conv_module`, as conformer_m_synthetic.py
# sets them, each block's attention runs on csrc/flash_relpos_{fwd,bwd}.cu
# and its conv module on csrc/conformer_conv_{fwd,bwd}.cu: per training
# step (B 128, 250 frames after the 4x subsampling) 16 launches of each
# forward and of each backward (the attention's dq and dkv 16 each). The
# loss and the decode are plain PyTorch, as the JAX package's are plain
# JAX. Data: synthetic batches of 128 x 1000 frames x 80 features with
# 160-label transcripts over 29 symbols; 20 training steps. `remat` is a
# key with no effect here.
from openseq2seq_tpu_torch.data.synthetic import SyntheticSpeechDataLayer
from openseq2seq_tpu_torch.decoders import TransducerDecoder
from openseq2seq_tpu_torch.encoders import ConformerEncoder
from openseq2seq_tpu_torch.losses import TransducerLoss
from openseq2seq_tpu_torch.models import Speech2Text

base_model = Speech2Text

base_params = {
    "random_seed": 0,
    "logdir": "conformer_transducer_synthetic_logs",
    "batch_size_per_gpu": 128,
    "optimizer": "AdamW",
    "optimizer_params": {"learning_rate": 2.0, "beta1": 0.9, "beta2": 0.98,
                         "epsilon": 1e-9, "weight_decay": 1e-6},
    "lr_policy": "transformer_policy",
    "lr_policy_params": {"learning_rate": 2.0, "d_model": 256,
                         "warmup_steps": 10000},
    "dtype": "mixed",
    "max_grad_norm": 5.0,
    "prng_impl": "rbg",
    "dropout_bits": 8,
    "remat": "blocks",
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
    "decoder": TransducerDecoder,
    "decoder_params": {
        "pred_embed_size": 320,
        "pred_units": 320,
        "pred_layers": 1,
        "joint_dim": 320,
        "dropout_keep_prob": 0.9,
        "max_symbols_per_frame": 3,
        "fused_loss": True,
    },
    "loss": TransducerLoss,
    "loss_params": {"fused_block_size": 8},
    "data_layer": SyntheticSpeechDataLayer,
    "data_layer_params": {
        "num_audio_features": 80,
        "tgt_vocab_size": 29,
        "time_steps": 1000,
        "label_length": 160,
        "num_batches": 8,
    },
}

train_params = {
    "max_steps": 20,
    "print_loss_steps": 1,
    "save_checkpoint_steps": 20,
}
