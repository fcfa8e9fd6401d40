# Transformer-big NMT eval and infer at full published width on synthetic
# text, for the PyTorch port:
#
#   python -m openseq2seq_tpu_torch.run --mode=eval --logdir=<dir> \
#       --config_file=example_configs_torch/text2text/transformer_big_synthetic.py
#
# and --mode=infer. The setup is the repository's NMT decode bench
# (scripts/bench_nmt_decode.py): d_model 1024, 16 heads, filter 4096, 6 + 6
# layers, a shared 32,768 vocabulary padded to eight (about 210 M
# parameters), bf16 compute from fp32 params ("mixed"), beam 4, alpha
# 0.6, 50 extra decode steps; batches of 64 sentences of 64 tokens, 2 per
# epoch. A tenth of each sequence on average is padding, so the
# key-padding masks of the encoder and the cross-attention have work to
# do. Training is not ported yet.
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
    "batch_size_per_gpu": 64,
    "dtype": "mixed",
    "logdir": "transformer_big_synthetic_logs",
    "encoder": TransformerEncoder,
    "encoder_params": {
        "encoder_layers": num_layers,
        "hidden_size": d_model,
        "num_heads": 16,
        "attention_dropout": 0.0,
        "filter_size": 4 * d_model,
        "relu_dropout": 0.0,
        "layer_postprocess_dropout": 0.0,
        "remove_padding": True,
        "pad_embeddings_2_eight": True,
        "use_flash_attention": True,
    },
    "decoder": TransformerDecoder,
    "decoder_params": {
        "EOS_ID": 1,
        "GO_SYMBOL": 2,
        "layer_postprocess_dropout": 0.0,
        "num_hidden_layers": num_layers,
        "hidden_size": d_model,
        "num_heads": 16,
        "attention_dropout": 0.0,
        "relu_dropout": 0.0,
        "filter_size": 4 * d_model,
        "beam_size": 4,
        "alpha": 0.6,
        "extra_decode_length": 50,
        "use_flash_attention": True,
        # a TPU cache layout of the JAX package (identical beams): a no-op
        # in the port, kept so the config reads as the repository's
        "decode_segments": 3,
    },
    "loss": PaddedCrossEntropyLossWithSmoothing,
    "loss_params": {"label_smoothing": 0.1},
    "data_layer": SyntheticTextDataLayer,
    "data_layer_params": {
        "src_vocab_size": 32768,
        "tgt_vocab_size": 32768,
        "src_length": 64,
        "tgt_length": 64,
        "num_batches": 2,
        "pad_fraction": 0.1,
    },
}
