"""The port's toy speech recipes (``example_configs_torch/speech2text/``
``w2lplus_toy.py``, ``ds2_toy_config.py``, ``conformer_toy.py``) trained
from the toy wavs through the port's CLI (``run.main``) on the CPU.

- w2lplus: a few steps (the loss falls), then infer from the checkpoint,
  whose CSV names each wav of the toy list once, in order;
- the DS2 toy's GRU (fp32, B 10, H 64) takes the fused path, which the
  JAX package's gate refuses at that width and the CUDA kernels take in
  fp32: on the CPU the kernels' plain versions run, forward and backward;
- marked ``slow``: each toy recipe to its end (w2lplus 150 epochs, the
  DS2 and Conformer toys 200), down to a validation WER of 0.0000.

Each run writes its toy set and logs under its own temporary directory
(``OS2S_TOY_DATA_DIR``, ``OS2S_TOY_LOGDIR``)."""
import csv
import os
import re

import pytest
import torch

from openseq2seq_tpu_torch import run
from openseq2seq_tpu_torch.ops import gru_scan
from openseq2seq_tpu_torch.test_utils import toy_speech
from test_torch_text_data import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "example_configs_torch", "speech2text")


@pytest.fixture
def toy_env(tmp_path, monkeypatch):
    monkeypatch.setenv("OS2S_TOY_DATA_DIR", str(tmp_path / "toy"))
    monkeypatch.setenv("OS2S_TOY_LOGDIR", str(tmp_path / "logs"))
    return tmp_path


def _run(config, capsys, *args):
    """``run.main`` on the CPU; returns its result and printed lines."""
    result = run.main(["--config_file=" + os.path.join(CONFIGS, config),
                       "--device=cpu", *args])
    return result, capsys.readouterr().out.splitlines()


def _losses(lines):
    return [float(x) for x in re.findall(r"loss = ([-+0-9.einaf]+)",
                                         "\n".join(lines))]


def test_w2lplus_toy_trains_and_infers(toy_env, capsys):
    """Four epochs of the 10 toy utterances (one step each): the loss
    falls at every step; infer from the final checkpoint writes one row
    per wav of the toy list, in its order."""
    result, lines = _run("w2lplus_toy.py", capsys, "--mode=train",
                         "--num_epochs=4", "--print_loss_steps=1")
    losses = _losses(lines)
    assert result["steps"] == 4 and len(losses) == 4
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    out = str(toy_env / "infer.csv")
    _run("w2lplus_toy.py", capsys, "--mode=infer",
         "--infer_output_file=" + out)
    with open(out, newline="") as f:
        rows = list(csv.reader(f))
    with open(toy_env / "toy" / "toy_data.csv", newline="") as f:
        wavs = [r["wav_filename"] for r in csv.DictReader(f)]
    assert rows[0] == ["wav_filename", "predicted_transcript"]
    assert [r[0] for r in rows[1:]] == wavs and len(wavs) == 10


def test_ds2_toy_gru_takes_the_fused_path(toy_env, capsys, monkeypatch):
    """The gate takes fp32 at H 64 at any B (not bf16, the JAX gate);
    two steps of the DS2 toy run the scan's plain forward (two
    directions) and backward each step, with a finite loss."""
    assert gru_scan.supported(10, 48, 64, torch.float32)
    assert not gru_scan.supported(10, 48, 64, torch.bfloat16)
    calls = {"fwd": 0, "bwd": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(gru_scan, "gru_scan_plain",
                        spy("fwd", gru_scan.gru_scan_plain))
    monkeypatch.setattr(gru_scan, "gru_scan_bwd_plain",
                        spy("bwd", gru_scan.gru_scan_bwd_plain))
    result, lines = _run("ds2_toy_config.py", capsys, "--mode=train",
                         "--num_epochs=2", "--print_loss_steps=1")
    losses = _losses(lines)
    assert result["steps"] == 2 and len(losses) == 2
    assert all(x == x and abs(x) < float("inf") for x in losses)
    assert calls == {"fwd": 4, "bwd": 4}


@pytest.mark.slow
@pytest.mark.parametrize("config", ["w2lplus_toy.py", "ds2_toy_config.py",
                                    "conformer_toy.py"])
def test_toy_recipe_reaches_wer_0(toy_env, capsys, config):
    """The recipe's whole ``train_eval`` run: the last validation reads
    WER 0.0000 (about 45 s for w2lplus, 2 to 4 minutes for the others, on
    a few CPU cores)."""
    _, lines = _run(config, capsys, "--mode=train_eval")
    wer = [x.strip() for x in lines if "Validation WER" in x]
    assert wer and wer[-1].endswith("Validation WER: 0.0000"), wer
    metrics, _ = _run(config, capsys, "--mode=eval")
    assert metrics["Eval WER"] == 0.0
    out = str(toy_env / "infer.csv")
    _run(config, capsys, "--mode=infer", "--infer_output_file=" + out)
    with open(out, newline="") as f:
        assert [r["predicted_transcript"] for r in csv.DictReader(f)] == \
            toy_speech.TRANSCRIPTS
