# Conformer-Transducer cut to two blocks of width 64 (2 heads of 32,
# depthwise kernel 7) with a prediction network and joint of width 32, fp32,
# on small synthetic batches (4 x 40 frames x 16 features, 10 frames after
# the 4x subsampling, 6-label transcripts over 8 symbols): the port's
# transducer training, eval and infer on the CPU in seconds, never timed:
#
#   python -m openseq2seq_tpu_torch.run --mode=train_eval --device=cpu \
#       --logdir=<dir> \
#       --config_file=example_configs_torch/speech2text/conformer_transducer_tiny_synthetic.py
#
# Both kernel flags are on, so the CPU runs the kernels' plain versions
# and the card the rel-pos flash and conv module kernels (head dim 32 and
# width 64 are the smallest they take). Training is the full recipe's
# setup (AdamW, transformer_policy, clipping at 5, dropout 0.1) with the
# warmup cut to 20 steps; the loss is the lattice one (--decoder_params/fused_loss=True
# for the fused one), greedy decode (--decoder_params/beam_width=4 for the
# beam).
from openseq2seq_tpu_torch.data.synthetic import SyntheticSpeechDataLayer
from openseq2seq_tpu_torch.decoders import TransducerDecoder
from openseq2seq_tpu_torch.encoders import ConformerEncoder
from openseq2seq_tpu_torch.losses import TransducerLoss
from openseq2seq_tpu_torch.models import Speech2Text

base_model = Speech2Text

base_params = {
    "random_seed": 0,
    "logdir": "conformer_transducer_tiny_synthetic_logs",
    "batch_size_per_gpu": 4,
    "dtype": "float32",
    "optimizer": "AdamW",
    "optimizer_params": {"learning_rate": 0.5, "beta1": 0.9, "beta2": 0.98,
                         "epsilon": 1e-9, "weight_decay": 1e-6},
    "lr_policy": "transformer_policy",
    "lr_policy_params": {"learning_rate": 0.5, "d_model": 64,
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
        "hidden_size": 64,
        "num_heads": 2,
        "conv_kernel_size": 7,
        "ffn_expansion": 4,
        "conv_norm": "layer_norm",
        "flash_attention": True,
        "fused_conv_module": True,
    },
    "decoder": TransducerDecoder,
    "decoder_params": {
        "pred_embed_size": 32,
        "pred_units": 32,
        "pred_layers": 1,
        "joint_dim": 32,
        "dropout_keep_prob": 0.9,
        "max_symbols_per_frame": 3,
        "fused_loss": False,
        "beam_width": 1,
    },
    "loss": TransducerLoss,
    "loss_params": {},
    "data_layer": SyntheticSpeechDataLayer,
    "data_layer_params": {
        "num_audio_features": 16,
        "tgt_vocab_size": 8,
        "time_steps": 40,
        "label_length": 6,
        "num_batches": 2,
    },
}
