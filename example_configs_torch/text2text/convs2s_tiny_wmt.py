"""A tiny fp32 twin of ``en_de_convs2s_wmt.py`` for the CPU, for the tests
and the docs (never timed): the same layout (GLU conv blocks of two
widths and a 1-wide last pair, 2 x (32, 3), 1 x (48, 3), 2 x (64, 1), so
that the residual projections and ``emb_proj`` run; the decoder's
causal), embeddings of 32, 8-bit dropout masks with the recipe's keep
0.8, Momentum with the recipe's ``exp_decay`` (lr 0.05, since the
recipe's 0.5 is for its width) and ``max_grad_norm`` 0.1, beam 3 with 8
extra decode steps; batches of 8 from a WMT-shaped corpus of 256 sentence
pairs over 20 word types (a 64-token vocabulary), written on first use by
``test_utils/fake_wmt.py`` under ``os2s_fake_wmt_tiny`` in the temporary
directory (or ``OS2S_FAKE_WMT_TINY_DIR``).

Run:
  python -m openseq2seq_tpu_torch.run --mode=train_eval --device=cpu \
      --logdir=<dir> \
      --config_file=example_configs_torch/text2text/convs2s_tiny_wmt.py
"""
import os
import tempfile

from openseq2seq_tpu_torch.data.text2text import ParallelTextDataLayer
from openseq2seq_tpu_torch.decoders import ConvS2SDecoder
from openseq2seq_tpu_torch.encoders import ConvS2SEncoder
from openseq2seq_tpu_torch.losses import BasicSequenceLoss
from openseq2seq_tpu_torch.models import Text2Text
from openseq2seq_tpu_torch.test_utils import fake_wmt

_DATA = fake_wmt.generate(
    os.environ.get("OS2S_FAKE_WMT_TINY_DIR", os.path.join(
        tempfile.gettempdir(), "os2s_fake_wmt_tiny")),
    n_train=256, n_dev=16, n_test=16, n_types=20, with_t2t=False)
_VOCAB = 4 + 3 * 20
_CONV = [(32, 3)] * 2 + [(48, 3)] + [(64, 1)] * 2

base_model = Text2Text
base_params = {
    "random_seed": 0,
    "dropout_bits": 8,
    "max_steps": 10,
    "logdir": "convs2s_tiny_wmt_logs",
    "batch_size_per_gpu": 8,
    "print_loss_steps": 1,
    "print_samples_steps": 5,
    "eval_steps": 5,
    "save_checkpoint_steps": 5,
    "optimizer": "Momentum",
    "optimizer_params": {"learning_rate": 0.05, "momentum": 0.99},
    "lr_policy": "exp_decay",
    "lr_policy_params": {"decay_steps": 4000, "decay_rate": 0.9,
                         "use_staircase_decay": True,
                         "begin_decay_at": 170000, "min_lr": 1e-4},
    "max_grad_norm": 0.1,
    "dtype": "float32",
    "encoder": ConvS2SEncoder,
    "encoder_params": {
        "src_emb_size": 32,
        "src_vocab_size": _VOCAB,
        "pad_embeddings_2_eight": True,
        "conv_nchannels_kwidth": _CONV,
        "embedding_dropout_keep_prob": 0.8,
        "hidden_dropout_keep_prob": 0.8,
        "max_input_length": 128,
    },
    "decoder": ConvS2SDecoder,
    "decoder_params": {
        "tgt_emb_size": 32,
        "tgt_vocab_size": _VOCAB,
        "out_emb_size": 32,
        "shared_embed": True,
        "conv_nchannels_kwidth": _CONV,
        "embedding_dropout_keep_prob": 0.8,
        "hidden_dropout_keep_prob": 0.8,
        "out_dropout_keep_prob": 0.8,
        "beam_size": 3,
        "alpha": 0.6,
        "extra_decode_length": 8,
        "EOS_ID": 1,
        "GO_SYMBOL": 2,
        "batch_size": 8,
        "max_input_length": 128,
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
        "max_length": 48,
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
