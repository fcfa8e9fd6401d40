"""The port imports torch and never jax, flax, optax, pandas or
ml_dtypes, nor any module of the JAX package; its CUDA wrapper leaves the
kernel alone for CPU tensors; and its entry point runs on the card unless
asked for the CPU."""
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from openseq2seq_tpu_torch import run
from openseq2seq_tpu_torch.ops import ctc, ctc_cuda
from test_torch_text_data import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "optax", "pandas", "ml_dtypes")
CONFIGS = sorted(glob.glob(os.path.join(REPO, "example_configs_torch", "*",
                                        "*.py")))


def _slice_modules():
    pkg = os.path.join(REPO, "openseq2seq_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in sorted(files):
            if name.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, name[:-3]), REPO)
                yield rel.replace(os.sep, ".").replace(".__init__", "")


def _import_all(report: str) -> str:
    """Import every port module and run every port config in a fresh
    interpreter; returns the last line it prints, ``report`` evaluated
    there."""
    modules = sorted(_slice_modules())
    assert {"openseq2seq_tpu_torch.ops.flash_attention",
            "openseq2seq_tpu_torch.ops.fused_dropout",
            "openseq2seq_tpu_torch.ops.gru_scan",
            "openseq2seq_tpu_torch.ops.lstm_scan",
            "openseq2seq_tpu_torch.ops.rnn_scan",
            "openseq2seq_tpu_torch.parts.rnns.rnn",
            "openseq2seq_tpu_torch.encoders.ds2_encoder",
            "openseq2seq_tpu_torch.encoders.conformer_encoder",
            "openseq2seq_tpu_torch.ops.flash_relpos",
            "openseq2seq_tpu_torch.ops.conformer_conv",
            "openseq2seq_tpu_torch.encoders.lm_encoders",
            "openseq2seq_tpu_torch.decoders.lm_decoders",
            "openseq2seq_tpu_torch.models.lstm_lm",
            "openseq2seq_tpu_torch.ops.features",
            "openseq2seq_tpu_torch.data.speech2text.speech2text",
            "openseq2seq_tpu_torch.test_utils.toy_speech",
            "openseq2seq_tpu_torch.test_utils.fake_librispeech",
            "openseq2seq_tpu_torch.data.text2text.text2text",
            "openseq2seq_tpu_torch.data.text2text.tokenizer",
            "openseq2seq_tpu_torch.data.text2text.wordpiece",
            "openseq2seq_tpu_torch.data.text2text.t2t",
            "openseq2seq_tpu_torch.encoders.rnn_encoders",
            "openseq2seq_tpu_torch.decoders.rnn_decoders",
            "openseq2seq_tpu_torch.test_utils.toy_nmt",
            "openseq2seq_tpu_torch.test_utils.fake_wmt",
            "openseq2seq_tpu_torch.test_utils.toy_tts",
            "openseq2seq_tpu_torch.data.text2speech.text2speech",
            "openseq2seq_tpu_torch.data.text2speech.speech_utils",
            "openseq2seq_tpu_torch.encoders.tacotron2_encoder",
            "openseq2seq_tpu_torch.decoders.tacotron2_decoder",
            "openseq2seq_tpu_torch.losses.text2speech_loss",
            "openseq2seq_tpu_torch.models.text2speech",
            "openseq2seq_tpu_torch.ops.transducer",
            "openseq2seq_tpu_torch.ops.arpa_lm",
            "openseq2seq_tpu_torch.ops.ngram_fusion",
            "openseq2seq_tpu_torch.losses.transducer_loss",
            "openseq2seq_tpu_torch.decoders.transducer_decoder",
            "openseq2seq_tpu_torch.data.lm.lmdata",
            "openseq2seq_tpu_torch.test_utils.fake_wikitext",
            "openseq2seq_tpu_torch.losses.cross_entropy_loss",
            "openseq2seq_tpu_torch.encoders.transformer_xl_encoder",
            "openseq2seq_tpu_torch.apps.lm_rescorer",
            "openseq2seq_tpu_torch.encoders.centaur_encoder",
            "openseq2seq_tpu_torch.decoders.centaur_decoder",
            "openseq2seq_tpu_torch.encoders.wavenet_encoder",
            "openseq2seq_tpu_torch.losses.wavenet_loss",
            "openseq2seq_tpu_torch.data.text2speech.text2speech_wavenet",
            "openseq2seq_tpu_torch.encoders.convs2s_encoder",
            "openseq2seq_tpu_torch.decoders.convs2s_decoder",
            "openseq2seq_tpu_torch.test_utils.fake_ljspeech",
            "openseq2seq_tpu_torch.test_utils.test_speech_configs",
            "openseq2seq_tpu_torch.encoders.las_encoder",
            "openseq2seq_tpu_torch.decoders.las_decoder",
            "openseq2seq_tpu_torch.decoders.jca_decoder",
            "openseq2seq_tpu_torch.losses.jca_loss",
            "openseq2seq_tpu_torch.ops.ctc_beam",
            "openseq2seq_tpu_torch.ops.ctc_beam_native",
            "openseq2seq_tpu_torch.ops.ctc_beam_device",
            "openseq2seq_tpu_torch.ops.features_device",
            "openseq2seq_tpu_torch.apps.frame_asr",
            "openseq2seq_tpu_torch.encoders.gatedconv_encoder",
            "openseq2seq_tpu_torch.serving",
            "openseq2seq_tpu_torch.serving.export",
            "openseq2seq_tpu_torch.serving.quantize",
            "openseq2seq_tpu_torch.serving.int8_exec"} <= set(modules)
    names = {os.path.basename(c) for c in CONFIGS}
    assert len(CONFIGS) >= 13 and {
        "transformer_big_train_synthetic.py", "ds2_medium_synthetic.py",
        "lstm_small_synthetic.py", "ds2_tiny_synthetic.py",
        "conformer_m_synthetic.py", "conformer_tiny_synthetic.py",
        "lstm_wkt103_synthetic.py", "lstm_lm_tiny_synthetic.py",
        "jasper10x5_librispeech.py", "w2lplus_toy.py", "ds2_toy_config.py",
        "conformer_toy.py", "nmt_reversal_toy.py", "nmt_reversal_toy_rnn.py",
        "transformer_big_wmt.py", "en_de_gnmt_like_wmt.py",
        "en_de_gnmt_like_tiny.py", "transformer_tiny_wmt.py",
        "tacotron2_synthetic.py", "tacotron_gst_synthetic.py",
        "tacotron_LJ.py", "tacotron_toy.py",
        "tacotron_tiny_synthetic.py", "conformer_transducer_synthetic.py",
        "conformer_transducer_decode_synthetic.py",
        "conformer_transducer_librispeech.py", "conformer_transducer_toy.py",
        "conformer_transducer_tiny_synthetic.py", "lstm_wkt103.py",
        "lstm_wkt2.py", "lstm_test_small.py", "lstm_test_small_mixed.py",
        "lstm_toy.py", "txl_wkt103.py", "txl_tiny.py", "imdb_wkt103.py",
        "imdb_wkt2.py", "imdb_from_scratch.py", "sst_wkt2.py",
        "sst_wkt2_small.py", "imdb_tiny.py", "centaur_float.py",
        "centaur_synthetic.py", "centaur_tiny_synthetic.py",
        "wavenet_LJ.py", "wavenet_float.py", "wavenet_toy.py",
        "wavenet_tiny.py", "en_de_convs2s_wmt.py",
        "nmt_reversal_toy_convs2s.py", "nmt_reversal_toy_cr.py",
        "nmt_reversal_toy_rc.py", "convs2s_tiny_wmt.py",
        "las_large_8gpus.py", "las_large_librispeech.py",
        "jca_large_8gpus.py", "las_toy.py", "las_tiny.py", "jca_tiny.py",
        "jasper10x5_beam_librispeech.py", "quartznet15x5_librispeech.py",
        "quartznet15x5_synthetic.py", "quartznet_tiny_synthetic.py",
        "jasper_mini.py", "w2lplus_toy_ondevice.py",
        "gatedconv_toy.py", "transformer_base_serving_synthetic.py",
        "transformer_base_serving_tiny_synthetic.py"} <= names
    code = ("import importlib, runpy, sys\n"
            "for m in {!r}: importlib.import_module(m)\n"
            "for c in {!r}: runpy.run_path(c)\n"
            "print({})\n").format(modules, CONFIGS, report)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip().splitlines()[-1]


def test_port_imports_no_jax():
    assert _import_all("sorted(m for m in {!r} if m in sys.modules)".format(
        FORBIDDEN)) == "[]"


def test_port_imports_nothing_of_the_jax_package():
    assert _import_all("sorted(m for m in sys.modules if m == "
                       "'openseq2seq_tpu' or m.startswith("
                       "'openseq2seq_tpu.'))") == "[]"


def _imported_modules(path):
    """The absolute module names that the file at ``path`` imports,
    anywhere in it (inside functions too)."""
    import ast
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_of_the_port_imports_jax():
    """Every source of the port's package, ``scripts_torch/``,
    ``example_configs_torch/`` and ``chip_smoke.py``, read with ``ast``
    (the imports inside functions, which an import of the module does not
    run, included): none names jax, flax, optax, pandas, ml_dtypes or the
    JAX package."""
    paths = [os.path.join(REPO, "chip_smoke.py")] + CONFIGS + sorted(
        glob.glob(os.path.join(REPO, "scripts_torch", "*.py")))
    for root, _, files in os.walk(os.path.join(REPO,
                                               "openseq2seq_tpu_torch")):
        paths += [os.path.join(root, n) for n in sorted(files)
                  if n.endswith(".py")]
    assert {"decode.py", "build_lm.py"} <= {os.path.basename(p)
                                            for p in paths}
    bad = [(os.path.relpath(p, REPO), m) for p in paths
           for m in _imported_modules(p)
           if m.split(".")[0] in FORBIDDEN + ("openseq2seq_tpu",)]
    assert not bad, bad


def test_run_main_without_cuda_needs_device_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    config = os.path.join(REPO, "example_configs_torch", "text2text",
                          "transformer_tiny_synthetic.py")
    with pytest.raises(RuntimeError, match="--device=cpu"):
        run.main(["--config_file=" + config, "--mode=eval",
                  "--logdir=" + str(tmp_path)])
    with pytest.raises(SystemExit):
        run.main(["--config_file=" + config, "--mode=eval",
                  "--logdir=" + str(tmp_path), "--device=tpu"])


def test_cpu_tensor_runs_plain_version_without_launch():
    rng = np.random.RandomState(0)
    lp = ctc.log_probs(torch.from_numpy(rng.randn(2, 9, 5)
                                        .astype(np.float32)))
    lengths = torch.tensor([9, 7], dtype=torch.int32)
    labels = torch.tensor([[1, 2, 2], [3, 0, 0]], dtype=torch.int32)
    label_lengths = torch.tensor([3, 1], dtype=torch.int32)
    before = ctc_cuda.LAUNCHES
    got = ctc_cuda.ctc_nll_cuda(lp, lengths, labels, label_lengths, 4)
    assert ctc_cuda.LAUNCHES == before
    torch.testing.assert_close(
        got, ctc_cuda.ctc_nll_plain(lp, lengths, labels, label_lengths, 4),
        rtol=0, atol=0)


def test_models_default_to_the_card():
    import runpy
    config = runpy.run_path(os.path.join(
        REPO, "example_configs_torch", "text2text",
        "transformer_tiny_synthetic.py"))
    model = config["base_model"](config["base_params"], mode="eval")
    assert model.device.type == "cuda"
    model = config["base_model"](config["base_params"], mode="eval",
                                 device="cpu")
    assert model.device.type == "cpu"


def test_summary_writer_is_read_back_by_the_jax_package(tmp_path):
    """The port's copy of the scalar event writer writes what the JAX
    package's reader reads."""
    from openseq2seq_tpu.utils.tb_writer import read_events
    from openseq2seq_tpu_torch.utils.tb_writer import SummaryWriter
    writer = SummaryWriter(str(tmp_path))
    writer.add_scalars(3, {"loss": 1.5, "learning_rate": 0.25, "x": None})
    writer.add_scalars(4, {"loss": 0.75})
    writer.close()
    assert read_events(writer.path)[-2:] == [
        (3, {"loss": 1.5, "learning_rate": 0.25}), (4, {"loss": 0.75})]


@pytest.mark.parametrize("name,n_params", [
    ("quartznet15x5_librispeech.py", 19257757),
    ("quartznet15x5_synthetic.py", 19257757),
    ("jasper_mini.py", None), ("w2lplus_toy_ondevice.py", None),
    ("gatedconv_toy.py", None)])
def test_asr_stack_recipes_build(name, n_params, tmp_path, monkeypatch):
    """The recipes of the ASR stack build their model on the CPU (the
    LibriSpeech ones over a two-utterance fake corpus, the toys over the
    toy wavs); QuartzNet-15x5 at its full width."""
    import runpy

    from openseq2seq_tpu_torch.test_utils import fake_librispeech
    monkeypatch.setenv("LIBRISPEECH_DIR", fake_librispeech.generate(
        str(tmp_path / "libri"), n_utts=2, duration=1.0,
        transcript_chars=10)[0])
    monkeypatch.setenv("OS2S_TOY_DATA_DIR", str(tmp_path / "toy"))
    config = runpy.run_path(os.path.join(REPO, "example_configs_torch",
                                         "speech2text", name))
    model = config["base_model"](dict(config["base_params"]), mode="eval",
                                 device="cpu")
    batch = next(iter(model.get_data_layer().iterate_one_epoch()))
    module = model.build_module(batch, torch.Generator().manual_seed(0))
    if n_params is not None:
        assert sum(p.numel() for p in module.parameters()) == n_params
