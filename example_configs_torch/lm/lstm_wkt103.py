"""LSTM language model on WikiText-103 with a sampled softmax over the
vocabulary, for the PyTorch port: the twin of
``example_configs/lm/lstm_wkt103.py``, key for key, reading
``WIKITEXT103_DIR`` (``wiki.{train,valid,test}.tokens`` or
``{train,valid,test}.txt``; the vocabulary and the ids are cached under
its ``processed/``, ``vocab.txt`` among them, which the transfer recipes
read). Full width: a 320-wide embedding, three 1024-unit LSTM layers, an
untied softmax, 8192 sampled candidates, 224 tracks of 96 tokens a
batch, bf16 compute from fp32 params ("mixed"); ``fused_rnn`` runs each
recurrence on kernel B3 (``csrc/lstm_scan_{fwd,bwd}.cu``), 3 launches
each way a train step and 3 an eval batch.

WikiText-103 is not in the repository; a corpus of its vocabulary size
(267,736 words with ``<unk>`` and ``<eos>``) is written by

  python -m openseq2seq_tpu_torch.test_utils.fake_wikitext --seed 0 DIR

Run:
  WIKITEXT103_DIR=DIR/wikitext-103 python -m openseq2seq_tpu_torch.run \\
      --mode=train_eval --config_file=example_configs_torch/lm/lstm_wkt103.py
"""
import os

from openseq2seq_tpu_torch.data.lm import WKTDataLayer
from openseq2seq_tpu_torch.decoders import FakeDecoder
from openseq2seq_tpu_torch.encoders import LMEncoder
from openseq2seq_tpu_torch.losses import BasicSampledSequenceLoss
from openseq2seq_tpu_torch.models import LSTMLM

_DATA = os.environ.get("WIKITEXT103_DIR", "/data/wikitext-103")

base_model = LSTMLM
base_params = {
    "random_seed": 0,
    "fused_rnn": True,
    "num_epochs": 25,
    "logdir": os.environ.get("OS2S_LOGDIR", "lm_wkt103_log"),
    "batch_size_per_gpu": 224,
    "print_loss_steps": 50,
    "save_summaries_steps": 200,
    "eval_steps": 8000,
    "save_checkpoint_steps": 5000,
    "num_checkpoints": 2,

    "optimizer": "Adam",
    "optimizer_params": {"learning_rate": 1e-3},
    "lr_policy": "exp_decay",
    "lr_policy_params": {"decay_steps": 40000, "decay_rate": 0.9,
                         "use_staircase_decay": True,
                         "begin_decay_at": 100000, "min_lr": 1e-6},
    "max_grad_norm": 0.25,
    "dtype": "mixed",

    "encoder": LMEncoder,
    "encoder_params": {
        "emb_size": 320,
        "encoder_layers": 3,
        "encoder_use_skip_connections": False,
        "core_cell": None,
        "core_cell_params": {"num_units": 1024},
        "use_cudnn_rnn": True,
        "cudnn_rnn_type": "cudnn_lstm",
        "weight_tied": False,
        "num_sampled": 8192,
        "encoder_emb_keep_prob": 0.9,
        "encoder_dp_input_keep_prob": 0.8,
        "encoder_dp_output_keep_prob": 0.8,
        "encoder_last_output_keep_prob": 0.8,
    },
    "decoder": FakeDecoder,
    "decoder_params": {},
    "loss": BasicSampledSequenceLoss,
    "loss_params": {},
    "data_layer": WKTDataLayer,
    "data_layer_params": {
        "data_root": _DATA,
        "processed_data_folder": os.path.join(_DATA, "processed"),
        "repeat": True,
        "bptt": 96,
        "rand_start": True,
    },
}
eval_params = {"data_layer_params": {"shuffle": False}}
