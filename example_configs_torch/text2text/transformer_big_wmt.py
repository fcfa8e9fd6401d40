"""Transformer-big EN->DE from text files at full width, for the PyTorch
port: the twin of ``example_configs/text2text/transformer-big.py`` (with
the ``transformer-base.py`` it builds on), every key as there: d_model
1024, 16 heads, filter 4096, 6 + 6 layers, attention dropout 0.1, relu and
residual dropout 0.3, 8-bit masks, "mixed", Adam (0.9, 0.997, 1e-9) with
the transformer schedule (lr 2.0, 8000 warmup steps), label smoothing 0.1,
batches of 256 sentence pairs of at most 56 tokens padded to eight, the
shared vocabulary padded to eight, beam 4 with alpha 0.6 and 50 extra
decode steps; eval and infer in batches of 16. 209,915,904 parameters at
a 32,768 vocabulary.

Its one departure: ``use_flash_attention: True`` in the encoder and the
decoder, as ``transformer_big_train_synthetic.py`` and ``bench_nmt.py``
set it, so that the attention runs on kernel B7, forward and backward.

The corpus is read in the layout of
``openseq2seq_tpu_torch/test_utils/fake_wmt.py`` (the recipe's own file
names) under ``WMT16_DIR``; ``fake_wmt.generate(dir, n_types=10921,
with_t2t=False)`` writes one of 32,767 tokens, 32,768 after
``pad_vocab_to_eight``.

Run:
  WMT16_DIR=<dir> python -m openseq2seq_tpu_torch.run --mode=train \
      --config_file=example_configs_torch/text2text/transformer_big_wmt.py
"""
import os

from openseq2seq_tpu_torch.data.text2text import ParallelTextDataLayer
from openseq2seq_tpu_torch.decoders import TransformerDecoder
from openseq2seq_tpu_torch.encoders import TransformerEncoder
from openseq2seq_tpu_torch.losses import PaddedCrossEntropyLossWithSmoothing
from openseq2seq_tpu_torch.models import Text2Text

_DATA = os.environ.get("WMT16_DIR", "/data/wmt16_en_dt")
d_model = 1024
num_layers = 6
dropout = 0.3

base_model = Text2Text
base_params = {
    "random_seed": 0,
    # a TPU knob of the JAX package (the dropout RNG): a no-op in the port
    "prng_impl": "rbg",
    "dropout_bits": 8,
    "max_steps": 300000,
    "logdir": os.environ.get("OS2S_LOGDIR", "transformer-big-log"),
    "batch_size_per_gpu": 256,
    "print_loss_steps": 100,
    "save_summaries_steps": 100,
    "eval_steps": 4000,
    "save_checkpoint_steps": 2000,
    "num_checkpoints": 5,

    "optimizer": "Adam",
    "optimizer_params": {"learning_rate": 2.0, "beta1": 0.9,
                         "beta2": 0.997, "epsilon": 1e-9},
    "lr_policy": "transformer_policy",
    "lr_policy_params": {"learning_rate": 2.0, "warmup_steps": 8000,
                         "d_model": d_model},
    "dtype": "mixed",

    "encoder": TransformerEncoder,
    "encoder_params": {
        "encoder_layers": num_layers,
        "hidden_size": d_model,
        "num_heads": 16,
        "attention_dropout": 0.1,
        "filter_size": 4 * d_model,
        "relu_dropout": dropout,
        "layer_postprocess_dropout": dropout,
        "remove_padding": True,
        "pad_embeddings_2_eight": True,
        "use_flash_attention": True,
    },
    "decoder": TransformerDecoder,
    "decoder_params": {
        "EOS_ID": 1,
        "GO_SYMBOL": 2,
        "layer_postprocess_dropout": dropout,
        "num_hidden_layers": num_layers,
        "hidden_size": d_model,
        "num_heads": 16,
        "attention_dropout": 0.1,
        "relu_dropout": dropout,
        "filter_size": 4 * d_model,
        "beam_size": 4,
        "alpha": 0.6,
        "extra_decode_length": 50,
        # a TPU cache layout of the JAX package: a no-op in the port
        "decode_segments": 3,
        "use_flash_attention": True,
    },
    "loss": PaddedCrossEntropyLossWithSmoothing,
    "loss_params": {"label_smoothing": 0.1},
    "data_layer": ParallelTextDataLayer,
    "data_layer_params": {
        "source_file": os.path.join(
            _DATA, "train.clean.en.shuffled.BPE_common.32K.tok"),
        "target_file": os.path.join(
            _DATA, "train.clean.de.shuffled.BPE_common.32K.tok"),
        "src_vocab_file": os.path.join(_DATA, "m_common.vocab"),
        "tgt_vocab_file": os.path.join(_DATA, "m_common.vocab"),
        "max_length": 56,
        "shuffle": True,
        "repeat": True,
        "pad_lengths_to_eight": True,
        "pad_vocab_to_eight": True,
    },
}

eval_params = {
    "batch_size_per_gpu": 16,
    "data_layer_params": {
        "source_file": os.path.join(_DATA,
                                    "wmt13-en-de.src.BPE_common.32K.tok"),
        "target_file": os.path.join(_DATA,
                                    "wmt13-en-de.ref.BPE_common.32K.tok"),
        "shuffle": False,
        "repeat": False,
        "max_length": 256,
    },
}
infer_params = {
    "batch_size_per_gpu": 16,
    "data_layer_params": {
        "source_file": os.path.join(_DATA,
                                    "wmt14-en-de.src.BPE_common.32K.tok"),
        "target_file": os.path.join(_DATA,
                                    "wmt14-en-de.src.BPE_common.32K.tok"),
        "use_targets": False,
        "shuffle": False,
        "repeat": False,
        "max_length": 256,
    },
}
