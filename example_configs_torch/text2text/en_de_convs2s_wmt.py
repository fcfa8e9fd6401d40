"""ConvS2S EN->DE at full width, for the PyTorch port: the twin of
``example_configs/text2text/en-de-convs2s.py``, every model, optimizer
and data key as there (embeddings of 512; an encoder and a decoder of 15
GLU conv blocks each, 9 x (512, 3), 4 x (1024, 3), 2 x (2048, 1), the
decoder's causal; source and target vocabularies of 32,768; beam 5 with
alpha 0.6 and 50 extra decode steps; batches of 64; "mixed"; 8-bit
dropout masks with keep 0.8; Momentum 0.5 with ``exp_decay`` and
``max_grad_norm`` 0.1). ``chip_smoke.py`` counts its parameters against
the JAX model's.

Only the file names differ: the corpus is read in the layout of
``openseq2seq_tpu_torch/test_utils/fake_wmt.py`` under ``WMT16_DIR``
(``train.clean.{en,de}.shuffled.BPE_common.32K.tok``, the shared
``m_common.vocab``, ``wmt13-en-de.*`` for eval and ``wmt14-en-de.src.*``
for infer). ``fake_wmt.generate(dir, n_types=10921, with_t2t=False)``
writes one whose vocabulary holds 4 + 3 x 10921 = 32,767 tokens, inside
the recipe's fixed 32,768.

Run:
  WMT16_DIR=<dir> python -m openseq2seq_tpu_torch.run --mode=train \
      --config_file=example_configs_torch/text2text/en_de_convs2s_wmt.py
"""
import os

from openseq2seq_tpu_torch.data.text2text import ParallelTextDataLayer
from openseq2seq_tpu_torch.decoders import ConvS2SDecoder
from openseq2seq_tpu_torch.encoders import ConvS2SEncoder
from openseq2seq_tpu_torch.losses import BasicSequenceLoss
from openseq2seq_tpu_torch.models import Text2Text

_DATA = os.environ.get("WMT16_DIR", "/data/wmt16_en_dt")
_CONV = [(512, 3)] * 9 + [(1024, 3)] * 4 + [(2048, 1)] * 2

base_model = Text2Text
base_params = {
    "random_seed": 0,
    # a TPU knob of the JAX package (the dropout RNG): a no-op in the port
    "prng_impl": "rbg",
    "dropout_bits": 8,
    "num_epochs": 30,
    "logdir": os.environ.get("OS2S_LOGDIR", "convs2s-log"),
    "batch_size_per_gpu": 64,
    "print_loss_steps": 100,
    "save_summaries_steps": 100,
    "eval_steps": 4000,
    "save_checkpoint_steps": 4000,
    "num_checkpoints": 5,
    "optimizer": "Momentum",
    "optimizer_params": {"learning_rate": 0.5, "momentum": 0.99},
    "lr_policy": "exp_decay",
    "lr_policy_params": {"decay_steps": 4000, "decay_rate": 0.9,
                         "use_staircase_decay": True,
                         "begin_decay_at": 170000, "min_lr": 1e-4},
    "max_grad_norm": 0.1,
    "dtype": "mixed",
    "encoder": ConvS2SEncoder,
    "encoder_params": {
        "src_emb_size": 512,
        "src_vocab_size": 32768,
        "pad_embeddings_2_eight": True,
        "conv_nchannels_kwidth": _CONV,
        "embedding_dropout_keep_prob": 0.8,
        "hidden_dropout_keep_prob": 0.8,
        "max_input_length": 1024,
    },
    "decoder": ConvS2SDecoder,
    "decoder_params": {
        "tgt_emb_size": 512,
        "tgt_vocab_size": 32768,
        "out_emb_size": 512,
        "shared_embed": True,
        "conv_nchannels_kwidth": _CONV,
        "embedding_dropout_keep_prob": 0.8,
        "hidden_dropout_keep_prob": 0.8,
        "out_dropout_keep_prob": 0.8,
        "beam_size": 5,
        "alpha": 0.6,
        "extra_decode_length": 50,
        "EOS_ID": 1,
        "GO_SYMBOL": 2,
        "batch_size": 64,
        "max_input_length": 1024,
    },
    "loss": BasicSequenceLoss,
    "loss_params": {"offset_target_by_one": True,
                    "average_across_timestep": True},
    "data_layer": ParallelTextDataLayer,
    "data_layer_params": {
        "source_file": os.path.join(
            _DATA, "train.clean.en.shuffled.BPE_common.32K.tok"),
        "target_file": os.path.join(
            _DATA, "train.clean.de.shuffled.BPE_common.32K.tok"),
        "src_vocab_file": os.path.join(_DATA, "m_common.vocab"),
        "tgt_vocab_file": os.path.join(_DATA, "m_common.vocab"),
        "max_length": 64,
        "shuffle": True,
        "repeat": True,
        "pad_lengths_to_eight": True,
    },
}
eval_params = {
    "data_layer_params": {
        "source_file": os.path.join(_DATA,
                                    "wmt13-en-de.src.BPE_common.32K.tok"),
        "target_file": os.path.join(_DATA,
                                    "wmt13-en-de.ref.BPE_common.32K.tok"),
        "shuffle": False, "repeat": False,
    },
}
infer_params = {
    "data_layer_params": {
        "source_file": os.path.join(_DATA,
                                    "wmt14-en-de.src.BPE_common.32K.tok"),
        "target_file": os.path.join(_DATA,
                                    "wmt14-en-de.src.BPE_common.32K.tok"),
        "use_targets": False, "shuffle": False, "repeat": False,
    },
}
