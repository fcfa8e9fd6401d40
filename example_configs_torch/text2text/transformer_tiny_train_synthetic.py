# A tiny fp32 twin of transformer_big_train_synthetic.py for the CPU, for
# the tests and the docs (never timed):
#
#   python -m openseq2seq_tpu_torch.run --mode=train_eval --device=cpu \
#       --logdir=<dir> \
#       --config_file=example_configs_torch/text2text/transformer_tiny_train_synthetic.py
#
# 2 + 2 layers of width 128 with 2 heads of 64 (the flash kernel's head
# dim), filter 256 (a multiple of 128, so the fused relu dropout's route is
# taken), a 61-token vocabulary, batches of 3 sentences of 12 tokens with
# 30% padding on average; the big config's dropout, u8 masks, NovoGrad and
# transformer schedule, with a warmup of 4 steps so that the loss falls
# within 10 steps on the repeated batch.
from openseq2seq_tpu_torch.data.synthetic import SyntheticTextDataLayer
from openseq2seq_tpu_torch.decoders import TransformerDecoder
from openseq2seq_tpu_torch.encoders import TransformerEncoder
from openseq2seq_tpu_torch.losses import PaddedCrossEntropyLossWithSmoothing
from openseq2seq_tpu_torch.models import Text2Text

d_model = 128

base_model = Text2Text
base_params = {
    "random_seed": 0,
    "max_steps": 10,
    "print_loss_steps": 1,
    "print_samples_steps": 5,
    "save_checkpoint_steps": 5,
    "eval_steps": 5,
    "batch_size_per_gpu": 3,
    "dtype": "float32",
    "dropout_bits": 8,
    "fused_residual_dropout": True,
    "logdir": "transformer_tiny_train_synthetic_logs",
    "optimizer": "NovoGrad",
    "optimizer_params": {"beta1": 0.95, "beta2": 0.99, "weight_decay": 1e-4},
    "lr_policy": "transformer_policy",
    "lr_policy_params": {"learning_rate": 2.0, "warmup_steps": 4,
                         "d_model": d_model},
    "encoder": TransformerEncoder,
    "encoder_params": {
        "encoder_layers": 2,
        "hidden_size": d_model,
        "num_heads": 2,
        "attention_dropout": 0.1,
        "filter_size": 2 * d_model,
        "relu_dropout": 0.3,
        "layer_postprocess_dropout": 0.3,
        "remove_padding": True,
        "use_flash_attention": True,
    },
    "decoder": TransformerDecoder,
    "decoder_params": {
        "EOS_ID": 1,
        "GO_SYMBOL": 2,
        "layer_postprocess_dropout": 0.3,
        "num_hidden_layers": 2,
        "hidden_size": d_model,
        "num_heads": 2,
        "attention_dropout": 0.1,
        "relu_dropout": 0.3,
        "filter_size": 2 * d_model,
        "beam_size": 4,
        "alpha": 0.6,
        "extra_decode_length": 4,
        "use_flash_attention": True,
    },
    "loss": PaddedCrossEntropyLossWithSmoothing,
    "loss_params": {"label_smoothing": 0.1},
    "data_layer": SyntheticTextDataLayer,
    "data_layer_params": {
        "src_vocab_size": 61,
        "tgt_vocab_size": 61,
        "src_length": 12,
        "tgt_length": 12,
        "num_batches": 2,
        "pad_fraction": 0.3,
    },
}
