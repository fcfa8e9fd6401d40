"""Toy NMT on the synthetic reversal task, a ConvS2S encoder and an RNN
attention decoder (the reference's "CR" wiring), for the PyTorch port:
the twin of ``example_configs/text2text/nmt_reversal_toy_cr.py``, key for
key (two GLU conv blocks of 48 channels; a one-layer LSTM decoder of 48
with Bahdanau attention; fp32, beam 4, Adam 1e-3).

Generates the toy corpus on first use under ``os2s_toy_nmt`` in the
temporary directory (or ``OS2S_TOY_NMT_DIR``) and logs under
``OS2S_TOY_NMT_LOGDIR``.

Run:
  python -m openseq2seq_tpu_torch.run --mode=train_eval --device=cpu \
      --config_file=example_configs_torch/text2text/nmt_reversal_toy_cr.py
"""
import os
import tempfile

from openseq2seq_tpu_torch.data.text2text import ParallelTextDataLayer
from openseq2seq_tpu_torch.decoders import BeamSearchRNNDecoderWithAttention
from openseq2seq_tpu_torch.encoders import ConvS2SEncoder
from openseq2seq_tpu_torch.losses import BasicSequenceLoss
from openseq2seq_tpu_torch.models import Text2Text
from openseq2seq_tpu_torch.test_utils import toy_nmt

_DATA_DIR = os.environ.get("OS2S_TOY_NMT_DIR", os.path.join(
    tempfile.gettempdir(), "os2s_toy_nmt"))
if not os.path.exists(os.path.join(_DATA_DIR, "train.src")):
    toy_nmt.generate(_DATA_DIR)
_DATA = {"train_src": os.path.join(_DATA_DIR, "train.src"),
         "train_tgt": os.path.join(_DATA_DIR, "train.tgt"),
         "eval_src": os.path.join(_DATA_DIR, "eval.src"),
         "eval_tgt": os.path.join(_DATA_DIR, "eval.tgt"),
         "vocab": os.path.join(_DATA_DIR, "vocab.txt")}

_VOCAB = 16  # toy reversal alphabet + specials

base_model = Text2Text
base_params = {
    "random_seed": 0,
    "num_epochs": 120,
    "logdir": os.environ.get("OS2S_TOY_NMT_LOGDIR", os.path.join(
        tempfile.gettempdir(), "os2s_torch_toy_nmt_cr_logs")),
    "batch_size_per_gpu": 32,
    "print_loss_steps": 100,
    "eval_steps": 400,
    "save_checkpoint_steps": 400,
    "num_checkpoints": 2,

    "optimizer": "Adam",
    "optimizer_params": {"learning_rate": 1e-3},
    "max_grad_norm": 3.0,
    "dtype": "float32",

    "encoder": ConvS2SEncoder,
    "encoder_params": {
        "src_emb_size": 48,
        "src_vocab_size": _VOCAB,
        "pad_embeddings_2_eight": False,
        "conv_nchannels_kwidth": [[48, 3]] * 2,
        "embedding_dropout_keep_prob": 0.9,
        "hidden_dropout_keep_prob": 0.9,
        "max_input_length": 64,
    },
    "decoder": BeamSearchRNNDecoderWithAttention,
    "decoder_params": {
        "GO_SYMBOL": 2,
        "END_SYMBOL": 1,
        "tgt_vocab_size": _VOCAB,
        "tgt_emb_size": 48,
        "attention_layer_size": 48,
        "attention_type": "bahdanau",
        "core_cell": "lstm",
        "core_cell_params": {"num_units": 48},
        "decoder_layers": 1,
        "decoder_use_skip_connections": False,
        "batch_size": 32,
        "beam_width": 4,
        "length_penalty": 1.0,
    },
    "loss": BasicSequenceLoss,
    "loss_params": {"offset_target_by_one": True,
                    "average_across_timestep": True, "do_mask": True},
    "data_layer": ParallelTextDataLayer,
    "data_layer_params": {
        "source_file": _DATA["train_src"],
        "target_file": _DATA["train_tgt"],
        "src_vocab_file": _DATA["vocab"],
        "tgt_vocab_file": _DATA["vocab"],
        "max_length": 16,
        "shuffle": True,
        "repeat": True,
        "special_tokens_already_in_vocab": False,
        "pad_lengths_to_eight": False,
    },
}
eval_params = {
    "data_layer_params": {
        "source_file": _DATA["eval_src"],
        "target_file": _DATA["eval_tgt"],
        "shuffle": False,
    },
}
infer_params = {
    "data_layer_params": {
        "source_file": _DATA["eval_src"],
        "target_file": _DATA["eval_tgt"],
        "shuffle": False,
        "use_targets": False,
    },
}
