"""A tiny fp32 twin of ``en_de_gnmt_like_wmt.py`` for the CPU, for the
tests and the docs (never timed): the same layout (a GNMT encoder of one
bidirectional and two unidirectional LSTM layers, so that the residual
from the third layer on runs; a 3-layer ``gnmt_v2`` decoder), width 64,
``fused_rnn`` (on the CPU the LSTM kernels' plain versions), 8-bit
dropout masks with the recipe's keep 0.8, Adam with the recipe's
``exp_decay`` and ``max_grad_norm``, beam 3; batches of 8 from a
WMT-shaped corpus of 256 sentence pairs over 20 word types (a 64-token
vocabulary), written on first use by ``test_utils/fake_wmt.py`` under
``os2s_fake_wmt_tiny`` in the temporary directory (or
``OS2S_FAKE_WMT_TINY_DIR``).

Run:
  python -m openseq2seq_tpu_torch.run --mode=train_eval --device=cpu \
      --logdir=<dir> \
      --config_file=example_configs_torch/text2text/en_de_gnmt_like_tiny.py
"""
import os
import tempfile

from openseq2seq_tpu_torch.data.text2text import ParallelTextDataLayer
from openseq2seq_tpu_torch.decoders import BeamSearchRNNDecoderWithAttention
from openseq2seq_tpu_torch.encoders import GNMTLikeEncoderWithEmbedding
from openseq2seq_tpu_torch.losses import BasicSequenceLoss
from openseq2seq_tpu_torch.models import Text2Text
from openseq2seq_tpu_torch.test_utils import fake_wmt

_DATA = fake_wmt.generate(
    os.environ.get("OS2S_FAKE_WMT_TINY_DIR", os.path.join(
        tempfile.gettempdir(), "os2s_fake_wmt_tiny")),
    n_train=256, n_dev=16, n_test=16, n_types=20, with_t2t=False)
_VOCAB = 4 + 3 * 20
H = 64

base_model = Text2Text
base_params = {
    "random_seed": 0,
    "fused_rnn": True,
    "dropout_bits": 8,
    "max_steps": 10,
    "logdir": "en_de_gnmt_like_tiny_logs",
    "batch_size_per_gpu": 8,
    "print_loss_steps": 1,
    "print_samples_steps": 5,
    "eval_steps": 5,
    "save_checkpoint_steps": 5,
    "optimizer": "Adam",
    "optimizer_params": {"learning_rate": 8e-4},
    "lr_policy": "exp_decay",
    "lr_policy_params": {"begin_decay_at": 170000, "decay_steps": 17000,
                         "decay_rate": 0.5, "use_staircase_decay": True,
                         "min_lr": 1e-6},
    "max_grad_norm": 32768.0,
    "dtype": "float32",
    "encoder": GNMTLikeEncoderWithEmbedding,
    "encoder_params": {
        "src_vocab_size": _VOCAB,
        "src_emb_size": H,
        "core_cell": "lstm",
        "core_cell_params": {"num_units": H},
        "encoder_layers": 3,
        "encoder_use_skip_connections": False,
        "encoder_dp_input_keep_prob": 0.8,
    },
    "decoder": BeamSearchRNNDecoderWithAttention,
    "decoder_params": {
        "GO_SYMBOL": 2,
        "END_SYMBOL": 1,
        "tgt_vocab_size": _VOCAB,
        "tgt_emb_size": H,
        "attention_layer_size": H,
        "attention_type": "gnmt_v2",
        "core_cell": "lstm",
        "core_cell_params": {"num_units": H},
        "decoder_layers": 3,
        "decoder_use_skip_connections": False,
        "decoder_dp_input_keep_prob": 0.8,
        "batch_size": 8,
        "beam_width": 3,
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
