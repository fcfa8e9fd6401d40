# Transformer-base teacher-forced scoring at the width of the repository's
# serving bench (scripts/bench_serving.py:58-117), for the PyTorch port's
# serving path (openseq2seq_tpu_torch/serving, docs/serving.md):
#
#   python scripts_torch/bench_serving.py
#
# d_model 512, 8 heads, filter 2048, 6 + 6 layers, a 32,768 vocabulary for
# source and target (shared table), bf16 compute from fp32 params
# ("mixed"), every dropout rate 0; batches of 64 sentences of 64 tokens, 2
# per epoch. The bench's keys, with one departure: use_flash_attention is
# True in the encoder and the decoder, so that the scoring forward runs
# kernel B7's forward, 18 launches a batch (6 encoder self-attentions, 6
# causal decoder self-attentions, 6 cross-attentions). Served with
# train=True and every rate 0, which is the teacher-forced logits without
# the beam decode that train=False appends (bench_serving.py:130-133).
# 60,917,760 parameters (the JAX model's, tests/test_torch_serving.py).
from openseq2seq_tpu_torch.data.synthetic import SyntheticTextDataLayer
from openseq2seq_tpu_torch.decoders import TransformerDecoder
from openseq2seq_tpu_torch.encoders import TransformerEncoder
from openseq2seq_tpu_torch.losses import PaddedCrossEntropyLossWithSmoothing
from openseq2seq_tpu_torch.models import Text2Text

d_model = 512
num_layers = 6

base_model = Text2Text
base_params = {
    "random_seed": 0,
    "max_steps": 1,
    "batch_size_per_gpu": 64,
    "print_loss_steps": None,
    "optimizer": "SGD",
    "lr_policy": "fixed_lr",
    "lr_policy_params": {"learning_rate": 1e-3},
    "dtype": "mixed",
    "logdir": "transformer_base_serving_synthetic_logs",
    "encoder": TransformerEncoder,
    "encoder_params": {
        "encoder_layers": num_layers,
        "hidden_size": d_model,
        "num_heads": d_model // 64,
        "attention_dropout": 0.0,
        "filter_size": 4 * d_model,
        "relu_dropout": 0.0,
        "layer_postprocess_dropout": 0.0,
        "remove_padding": False,
        "use_flash_attention": True,
    },
    "decoder": TransformerDecoder,
    "decoder_params": {
        "EOS_ID": 1,
        "GO_SYMBOL": 2,
        "layer_postprocess_dropout": 0.0,
        "num_hidden_layers": num_layers,
        "hidden_size": d_model,
        "num_heads": d_model // 64,
        "attention_dropout": 0.0,
        "relu_dropout": 0.0,
        "filter_size": 4 * d_model,
        "beam_size": 4,
        "alpha": 0.6,
        "extra_decode_length": 8,
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
        "num_batches": 2,
    },
}
