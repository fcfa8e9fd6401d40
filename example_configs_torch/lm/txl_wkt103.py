"""Transformer-XL language model on WikiText-103, for the PyTorch port:
the twin of ``example_configs/lm/txl_wkt103.py``, key for key, reading
``WIKITEXT103_DIR``: 16 layers, d 410, 10 heads of 41, d_inner 2100,
dropout 0.1, the softmax tied to the embedding, 64 tracks of 192 tokens a
batch, "mixed", Adam with ``cosine_decay`` (4,000 warmup steps),
``max_grad_norm`` 0.25. Training and scoring take one segment a batch
(``mem_len`` 0); streaming segments with memory is the module's
(``TransformerXLNet.forward(..., mems=, mems_valid=)``). The fp32 logits
of a batch are (64, 192, V), 13.2 GB at WikiText-103's V of 267,736.
A trained checkpoint rescores n-best lists through
``openseq2seq_tpu_torch.apps.NeuralRescorer``.

Run:
  WIKITEXT103_DIR=<dir> python -m openseq2seq_tpu_torch.run \\
      --mode=train_eval --config_file=example_configs_torch/lm/txl_wkt103.py
"""
import os

from openseq2seq_tpu_torch.data.lm import WKTDataLayer
from openseq2seq_tpu_torch.decoders import FakeDecoder
from openseq2seq_tpu_torch.encoders import TransformerXLEncoder
from openseq2seq_tpu_torch.losses import BasicSequenceLoss
from openseq2seq_tpu_torch.models import LSTMLM

_DATA = os.environ.get("WIKITEXT103_DIR", "/data/wikitext-103")

base_model = LSTMLM
base_params = {
    "random_seed": 0,
    "num_epochs": 25,
    "logdir": os.environ.get("OS2S_LOGDIR", "txl_wkt103_log"),
    "batch_size_per_gpu": 64,
    "print_loss_steps": 50,
    "save_summaries_steps": 200,
    "eval_steps": 8000,
    "save_checkpoint_steps": 5000,
    "num_checkpoints": 2,

    "optimizer": "Adam",
    "optimizer_params": {"learning_rate": 2.5e-4},
    "lr_policy": "cosine_decay",
    # cosine_decay's min_lr is a fraction of the base lr: 0.004 * 2.5e-4
    "lr_policy_params": {"learning_rate": 2.5e-4, "warmup_steps": 4000,
                         "decay_steps": 200000, "min_lr": 0.004},
    "max_grad_norm": 0.25,
    "dtype": "mixed",

    "encoder": TransformerXLEncoder,
    "encoder_params": {
        "num_layers": 16,
        "hidden_size": 410,
        "num_heads": 10,
        "filter_size": 2100,
        "dropout": 0.1,
        "attention_dropout": 0.0,
        "mem_len": 0,
    },
    "decoder": FakeDecoder,
    "decoder_params": {},
    "loss": BasicSequenceLoss,
    "loss_params": {"average_across_timestep": True, "do_mask": False},
    "data_layer": WKTDataLayer,
    "data_layer_params": {
        "data_root": _DATA,
        "processed_data_folder": os.path.join(_DATA, "processed"),
        "bptt": 192,
        "repeat": True,
    },
}
eval_params = {
    "data_layer_params": {"repeat": False},
}
