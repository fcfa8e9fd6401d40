"""Synthetic toy NMT task: reverse a sequence of digit tokens (the port's
copy of ``openseq2seq_tpu/test_utils/toy_nmt.py``: the same arguments
write the same files; the reference's toy reversal corpus,
`scripts/create_toy_data.sh` + `text2text_test.py`). Deterministic
generation, no binaries. :func:`transformer_toy_config` builds the toy
transformer on the port's classes."""
from __future__ import annotations

import os

import numpy as np

VOCAB_TOKENS = [str(d) for d in range(10)]


def generate(out_dir: str, num_train: int = 512, num_eval: int = 32,
             min_len: int = 3, max_len: int = 8, seed: int = 0
             ) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)

    def make_corpus(n, tag):
        src_path = os.path.join(out_dir, "{}.src".format(tag))
        tgt_path = os.path.join(out_dir, "{}.tgt".format(tag))
        with open(src_path, "w") as fs, open(tgt_path, "w") as ft:
            for _ in range(n):
                length = rng.randint(min_len, max_len + 1)
                tokens = [VOCAB_TOKENS[rng.randint(10)]
                          for _ in range(length)]
                fs.write(" ".join(tokens) + "\n")
                ft.write(" ".join(reversed(tokens)) + "\n")
        return src_path, tgt_path

    train_src, train_tgt = make_corpus(num_train, "train")
    eval_src, eval_tgt = make_corpus(num_eval, "eval")
    vocab_path = os.path.join(out_dir, "vocab.txt")
    with open(vocab_path, "w") as f:
        for tok in VOCAB_TOKENS:
            f.write(tok + "\n")
    return {"train_src": train_src, "train_tgt": train_tgt,
            "eval_src": eval_src, "eval_tgt": eval_tgt,
            "vocab": vocab_path, "dir": out_dir}


def transformer_toy_config(data: dict, mode_files: str = "train",
                           dtype: str = "float32", num_epochs: int = 40):
    """Small transformer config on the reversal task."""
    from ..data.text2text import ParallelTextDataLayer
    from ..decoders import TransformerDecoder
    from ..encoders import TransformerEncoder
    from ..losses import PaddedCrossEntropyLossWithSmoothing
    from ..models import Text2Text

    d_model = 64
    base_params = {
        "random_seed": 0,
        "num_epochs": num_epochs,
        "logdir": "",
        "batch_size_per_gpu": 32,
        "print_loss_steps": 50,
        "save_checkpoint_steps": None,
        "eval_steps": 200,

        "optimizer": "Adam",
        "optimizer_params": {"learning_rate": 1e-3,
                             "beta1": 0.9, "beta2": 0.997,
                             "epsilon": 1e-9},
        "lr_policy": "transformer_policy",
        "lr_policy_params": {"learning_rate": 1.0, "warmup_steps": 200,
                             "d_model": d_model},
        "dtype": dtype,
        "encoder": TransformerEncoder,
        "encoder_params": {
            "encoder_layers": 2,
            "hidden_size": d_model,
            "num_heads": 4,
            "attention_dropout": 0.1,
            "filter_size": 4 * d_model,
            "relu_dropout": 0.1,
            "layer_postprocess_dropout": 0.1,
            "remove_padding": True,
        },
        "decoder": TransformerDecoder,
        "decoder_params": {
            "EOS_ID": 1,
            "layer_postprocess_dropout": 0.1,
            "num_hidden_layers": 2,
            "hidden_size": d_model,
            "num_heads": 4,
            "attention_dropout": 0.1,
            "relu_dropout": 0.1,
            "filter_size": 4 * d_model,
            "beam_size": 2,
            "alpha": 0.6,
            "extra_decode_length": 4,
            "GO_SYMBOL": 2,
        },
        "loss": PaddedCrossEntropyLossWithSmoothing,
        "loss_params": {"label_smoothing": 0.1},
        "data_layer": ParallelTextDataLayer,
        "data_layer_params": {
            "source_file": data["{}_src".format(mode_files)],
            "target_file": data["{}_tgt".format(mode_files)],
            "src_vocab_file": data["vocab"],
            "tgt_vocab_file": data["vocab"],
            "max_length": 16,
            "shuffle": mode_files == "train",
            "repeat": True,
            "special_tokens_already_in_vocab": False,
            "pad_lengths_to_eight": False,
        },
    }
    return base_params
