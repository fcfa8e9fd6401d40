"""A tiny fp32 twin of ``transformer_big_wmt.py`` for the CPU, for the
tests and the docs (never timed): 2 + 2 layers of width 128 with 2 heads
of 64, filter 256, the recipe's dropout, 8-bit masks, Adam and
transformer schedule (its scale cut to 0.1 and its warmup to 4 steps,
a peak of 4.4e-3), label smoothing, flash
attention (on the CPU its plain version), lengths and vocabulary padded
to eight; batches of 8 from a WMT-shaped corpus of 256 sentence pairs
over 20 word types (a 64-token vocabulary), written on first use by
``test_utils/fake_wmt.py`` under ``os2s_fake_wmt_tiny`` in the temporary
directory (or ``OS2S_FAKE_WMT_TINY_DIR``); eval and infer in batches of 4
with beam 2.

Run:
  python -m openseq2seq_tpu_torch.run --mode=train_eval --device=cpu \
      --logdir=<dir> \
      --config_file=example_configs_torch/text2text/transformer_tiny_wmt.py
"""
import os
import tempfile

from openseq2seq_tpu_torch.data.text2text import ParallelTextDataLayer
from openseq2seq_tpu_torch.decoders import TransformerDecoder
from openseq2seq_tpu_torch.encoders import TransformerEncoder
from openseq2seq_tpu_torch.losses import PaddedCrossEntropyLossWithSmoothing
from openseq2seq_tpu_torch.models import Text2Text
from openseq2seq_tpu_torch.test_utils import fake_wmt

_DATA = fake_wmt.generate(
    os.environ.get("OS2S_FAKE_WMT_TINY_DIR", os.path.join(
        tempfile.gettempdir(), "os2s_fake_wmt_tiny")),
    n_train=256, n_dev=16, n_test=16, n_types=20, with_t2t=False)
d_model = 128
dropout = 0.3

base_model = Text2Text
base_params = {
    "random_seed": 0,
    "dropout_bits": 8,
    "max_steps": 10,
    "logdir": "transformer_tiny_wmt_logs",
    "batch_size_per_gpu": 8,
    "print_loss_steps": 1,
    "print_samples_steps": 5,
    "eval_steps": 5,
    "save_checkpoint_steps": 5,
    "optimizer": "Adam",
    "optimizer_params": {"learning_rate": 2.0, "beta1": 0.9,
                         "beta2": 0.997, "epsilon": 1e-9},
    "lr_policy": "transformer_policy",
    "lr_policy_params": {"learning_rate": 0.1, "warmup_steps": 4,
                         "d_model": d_model},
    "dtype": "float32",
    "encoder": TransformerEncoder,
    "encoder_params": {
        "encoder_layers": 2,
        "hidden_size": d_model,
        "num_heads": 2,
        "attention_dropout": 0.1,
        "filter_size": 2 * d_model,
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
        "num_hidden_layers": 2,
        "hidden_size": d_model,
        "num_heads": 2,
        "attention_dropout": 0.1,
        "relu_dropout": dropout,
        "filter_size": 2 * d_model,
        "beam_size": 2,
        "alpha": 0.6,
        "extra_decode_length": 4,
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
    "batch_size_per_gpu": 4,
    "data_layer_params": {
        "source_file": os.path.join(_DATA,
                                    "wmt13-en-de.src.BPE_common.32K.tok"),
        "target_file": os.path.join(_DATA,
                                    "wmt13-en-de.ref.BPE_common.32K.tok"),
        "shuffle": False, "repeat": False, "max_length": 256,
    },
}
infer_params = {
    "batch_size_per_gpu": 4,
    "data_layer_params": {
        "source_file": os.path.join(_DATA,
                                    "wmt14-en-de.src.BPE_common.32K.tok"),
        "target_file": os.path.join(_DATA,
                                    "wmt14-en-de.src.BPE_common.32K.tok"),
        "use_targets": False, "shuffle": False, "repeat": False,
        "max_length": 256,
    },
}
