"""GNMT-like EN->DE at full width, for the PyTorch port: the twin of
``example_configs/text2text/en-de-gnmt-like.py``, every model, optimizer
and data key as there (a 7-layer GNMT encoder, one bidirectional LSTM
layer and six unidirectional ones, and an 8-layer ``gnmt_v2`` attention
decoder, all LSTM of width 1024; embeddings of 1024; source and target
vocabularies of 32,768; beam 10 with length penalty 1; batches of 32;
"mixed"; ``fused_rnn``, so that the encoder's recurrences run on kernel
B3, forward and backward; 8-bit dropout masks; Adam 8e-4 with
``exp_decay``; ``max_grad_norm`` 32768). 308,382,720 parameters
(encoder 104,890,368, decoder 203,492,352; ``chip_smoke.py`` counts
them in its GNMT phase).

Only the file names differ: the corpus is read in the layout of
``openseq2seq_tpu_torch/test_utils/fake_wmt.py`` under ``WMT16_DIR``
(``train.clean.{en,de}.shuffled.BPE_common.32K.tok``, the shared
``m_common.vocab``, ``wmt13-en-de.*`` for eval and ``wmt14-en-de.src.*``
for infer). ``fake_wmt.generate(dir, n_types=10921, with_t2t=False)``
writes one whose vocabulary holds 4 + 3 x 10921 = 32,767 tokens, inside
the recipe's fixed 32,768.

Run:
  WMT16_DIR=<dir> python -m openseq2seq_tpu_torch.run --mode=train \
      --config_file=example_configs_torch/text2text/en_de_gnmt_like_wmt.py
"""
import os

from openseq2seq_tpu_torch.data.text2text import ParallelTextDataLayer
from openseq2seq_tpu_torch.decoders import BeamSearchRNNDecoderWithAttention
from openseq2seq_tpu_torch.encoders import GNMTLikeEncoderWithEmbedding
from openseq2seq_tpu_torch.losses import BasicSequenceLoss
from openseq2seq_tpu_torch.models import Text2Text

_DATA = os.environ.get("WMT16_DIR", "/data/wmt16_en_dt")

base_model = Text2Text
base_params = {
    "random_seed": 0,
    "fused_rnn": True,
    # a TPU knob of the JAX package (the dropout RNG): a no-op in the port
    "prng_impl": "rbg",
    "dropout_bits": 8,
    "num_epochs": 8,
    "logdir": os.environ.get("OS2S_LOGDIR", "gnmt-log"),
    "batch_size_per_gpu": 32,
    "print_loss_steps": 50,
    "save_summaries_steps": 100,
    "eval_steps": 4000,
    "save_checkpoint_steps": 4000,
    "num_checkpoints": 5,
    "optimizer": "Adam",
    "optimizer_params": {"learning_rate": 8e-4},
    "lr_policy": "exp_decay",
    "lr_policy_params": {"begin_decay_at": 170000, "decay_steps": 17000,
                         "decay_rate": 0.5, "use_staircase_decay": True,
                         "min_lr": 1e-6},
    "max_grad_norm": 32768.0,
    "dtype": "mixed",
    "encoder": GNMTLikeEncoderWithEmbedding,
    "encoder_params": {
        "src_vocab_size": 32768,
        "src_emb_size": 1024,
        "core_cell": "lstm",
        "core_cell_params": {"num_units": 1024},
        "encoder_layers": 7,
        "encoder_use_skip_connections": False,
        "encoder_dp_input_keep_prob": 0.8,
    },
    "decoder": BeamSearchRNNDecoderWithAttention,
    "decoder_params": {
        "GO_SYMBOL": 2,
        "END_SYMBOL": 1,
        "tgt_vocab_size": 32768,
        "tgt_emb_size": 1024,
        "attention_layer_size": 1024,
        "attention_type": "gnmt_v2",
        "core_cell": "lstm",
        "core_cell_params": {"num_units": 1024},
        "decoder_layers": 8,
        "decoder_use_skip_connections": False,
        # accepted with no effect, as in the JAX package (C23)
        "decoder_dp_input_keep_prob": 0.8,
        "batch_size": 32,
        "beam_width": 10,
        "length_penalty": 1.0,
    },
    "loss": BasicSequenceLoss,
    "loss_params": {"offset_target_by_one": True,
                    "average_across_timestep": True, "do_mask": True},
    "data_layer": ParallelTextDataLayer,
    "data_layer_params": {
        "source_file": os.path.join(
            _DATA, "train.clean.en.shuffled.BPE_common.32K.tok"),
        "target_file": os.path.join(
            _DATA, "train.clean.de.shuffled.BPE_common.32K.tok"),
        "src_vocab_file": os.path.join(_DATA, "m_common.vocab"),
        "tgt_vocab_file": os.path.join(_DATA, "m_common.vocab"),
        "max_length": 50,
        "shuffle": True,
        "repeat": True,
    },
}
eval_params = {
    "data_layer_params": {
        "source_file": os.path.join(_DATA,
                                    "wmt13-en-de.src.BPE_common.32K.tok"),
        "target_file": os.path.join(_DATA,
                                    "wmt13-en-de.ref.BPE_common.32K.tok"),
        "shuffle": False, "repeat": False, "max_length": 32,
    },
}
infer_params = {
    "data_layer_params": {
        "source_file": os.path.join(_DATA,
                                    "wmt14-en-de.src.BPE_common.32K.tok"),
        "target_file": os.path.join(_DATA,
                                    "wmt14-en-de.src.BPE_common.32K.tok"),
        "use_targets": False, "shuffle": False, "repeat": False,
        "max_length": 256,
    },
}
