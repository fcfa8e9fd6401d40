"""The port imports torch and never jax, flax, optax or pandas; and its
CUDA wrapper leaves the kernel alone for CPU tensors."""
import os
import subprocess
import sys

import numpy as np
import torch

from openseq2seq_tpu_torch.ops import ctc, ctc_cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "optax", "pandas")


def _slice_modules():
    pkg = os.path.join(REPO, "openseq2seq_tpu_torch")
    for root, _, files in os.walk(pkg):
        for name in sorted(files):
            if name.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, name[:-3]), REPO)
                yield rel.replace(os.sep, ".").replace(".__init__", "")


def test_port_imports_no_jax():
    modules = sorted(_slice_modules())
    assert "openseq2seq_tpu_torch.ops.ctc_cuda" in modules
    code = ("import importlib, runpy, sys\n"
            "for m in {!r}: importlib.import_module(m)\n"
            "runpy.run_path({!r})\n"
            "print(sorted(m for m in {!r} if m in sys.modules))\n").format(
                modules, os.path.join(REPO, "example_configs_torch",
                                      "speech2text",
                                      "jasper10x5_synthetic.py"), FORBIDDEN)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


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
