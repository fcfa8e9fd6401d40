# Transformer-big NMT training at full published width on synthetic text,
# for the PyTorch port:
#
#   python -m openseq2seq_tpu_torch.run --mode=train --logdir=<dir> \
#       --config_file=example_configs_torch/text2text/transformer_big_train_synthetic.py
#
# and --mode=eval from the checkpoint it writes. The step is the
# repository's NMT train bench (bench_nmt.py) with BENCH_NMT_FLASH=1,
# BENCH_NMT_FUSEDDROP=1 and BENCH_NMT_PADFRAC=0.1: d_model 1024, 16 heads,
# filter 4096, 6 + 6 layers, a shared 32,768 vocabulary padded to eight
# (209,915,904 parameters), bf16 compute from fp32 params ("mixed"), u8
# dropout masks, dropout 0.1 on attention and 0.3 on the relu and the
# residual branches; NovoGrad with the transformer (Noam) schedule; label
# smoothing 0.1; batches of 64 sentences of 64 + 64 tokens, 4 per epoch,
# with a tenth of each sequence padding on average. Flash attention
# (kernel B7, forward and backward) runs at its 18 sites per step and the
# fused relu dropout (kernel B2) at the 12 FFNs. Nothing is cut; 20 steps.
# The recipe's 8000 warmup steps keep the learning rate under 2e-6 over
# them: to see the loss fall in a short run, pass e.g.
# --lr_policy_params/warmup_steps=20.
from openseq2seq_tpu_torch.data.synthetic import SyntheticTextDataLayer
from openseq2seq_tpu_torch.decoders import TransformerDecoder
from openseq2seq_tpu_torch.encoders import TransformerEncoder
from openseq2seq_tpu_torch.losses import PaddedCrossEntropyLossWithSmoothing
from openseq2seq_tpu_torch.models import Text2Text

d_model = 1024
num_layers = 6

base_model = Text2Text
base_params = {
    "random_seed": 0,
    "max_steps": 20,
    "print_loss_steps": 10,
    "save_checkpoint_steps": 20,
    "batch_size_per_gpu": 64,
    "dtype": "mixed",
    "dropout_bits": 8,
    "fused_residual_dropout": True,
    # a TPU knob of the JAX package (the dropout RNG): a no-op in the port
    "prng_impl": "rbg",
    "logdir": "transformer_big_train_synthetic_logs",
    "optimizer": "NovoGrad",
    "optimizer_params": {"beta1": 0.95, "beta2": 0.99, "weight_decay": 1e-4},
    "lr_policy": "transformer_policy",
    "lr_policy_params": {"learning_rate": 2.0, "warmup_steps": 8000,
                         "d_model": d_model},
    "encoder": TransformerEncoder,
    "encoder_params": {
        "encoder_layers": num_layers,
        "hidden_size": d_model,
        "num_heads": 16,
        "attention_dropout": 0.1,
        "filter_size": 4 * d_model,
        "relu_dropout": 0.3,
        "layer_postprocess_dropout": 0.3,
        "remove_padding": True,
        "pad_embeddings_2_eight": True,
        "use_flash_attention": True,
    },
    "decoder": TransformerDecoder,
    "decoder_params": {
        "EOS_ID": 1,
        "GO_SYMBOL": 2,
        "layer_postprocess_dropout": 0.3,
        "num_hidden_layers": num_layers,
        "hidden_size": d_model,
        "num_heads": 16,
        "attention_dropout": 0.1,
        "relu_dropout": 0.3,
        "filter_size": 4 * d_model,
        "beam_size": 4,
        "alpha": 0.6,
        "extra_decode_length": 50,
        "use_flash_attention": True,
    },
    "loss": PaddedCrossEntropyLossWithSmoothing,
    "loss_params": {"label_smoothing": 0.1},
    "data_layer": SyntheticTextDataLayer,
    "data_layer_params": {
        "src_vocab_size": 32768,
        "tgt_vocab_size": 32768,
        "src_length": 64,
        "tgt_length": 64,
        "num_batches": 4,
        "pad_fraction": 0.1,
    },
}
