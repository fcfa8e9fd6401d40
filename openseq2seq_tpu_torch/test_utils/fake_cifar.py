"""A CIFAR-10-shaped set in the binary layout (``data_batch_*.bin``,
``test_batch.bin``: per record one label byte and 3 x 32 x 32 image bytes,
channel-major) with 10 learnable classes, for the image models' tests and
the CIFAR toy (``example_configs_torch/image2label/cifar10_nv.py`` with
``CIFAR10_DIR`` pointing here).

Class k is a stripe pattern: along the rows for even k, along the columns
for odd k, of period 2 ** (k // 2 + 1) pixels (2 to 32), in a colour of
its own, plus noise. A pattern keeps its orientation, period and colour
under the data layer's flip and pad-4 crop and under per-image
standardization, so a small CNN learns the classes in a few hundred
steps. The JAX package's test (``tests/test_image2label.py``) uses four
row-stripe classes of the same kind.

    python -m openseq2seq_tpu_torch.test_utils.fake_cifar <dir> [--train N]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

NUM_CLASSES = 10
_COLOURS = np.array([[1.0, 0.6, 0.3], [0.3, 1.0, 0.6], [0.6, 0.3, 1.0],
                     [1.0, 1.0, 0.3], [0.3, 1.0, 1.0], [1.0, 0.3, 1.0],
                     [1.0, 0.5, 0.5], [0.5, 1.0, 0.5], [0.5, 0.5, 1.0],
                     [0.8, 0.8, 0.8]], np.float32)


def image(label: int, rng: np.random.RandomState) -> np.ndarray:
    """One (3, 32, 32) uint8 image of class ``label``."""
    period = 2 ** (label // 2 + 1)
    phase = rng.randint(period)
    stripe = (((np.arange(32) + phase) // max(period // 2, 1)) % 2) * 140.0 \
        + 60.0
    plane = stripe[:, None] * np.ones((1, 32)) if label % 2 == 0 else \
        np.ones((32, 1)) * stripe[None, :]
    img = _COLOURS[label][:, None, None] * plane[None]
    return np.clip(img + rng.randn(3, 32, 32) * 10, 0, 255).astype(np.uint8)


def write_records(path: str, n: int, rng: np.random.RandomState) -> None:
    labels = rng.randint(NUM_CLASSES, size=n)
    recs = [np.concatenate([[lab], image(lab, rng).ravel()]).astype(np.uint8)
            for lab in labels]
    np.stack(recs).tofile(path)


def generate(out_dir: str, n_train: int = 1280, n_test: int = 256,
             seed: int = 0) -> str:
    """Write ``data_batch_1.bin`` (``n_train`` records) and
    ``test_batch.bin`` (``n_test``) under ``out_dir``; returns it."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    write_records(os.path.join(out_dir, "data_batch_1.bin"), n_train, rng)
    write_records(os.path.join(out_dir, "test_batch.bin"), n_test, rng)
    return out_dir


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("out_dir")
    parser.add_argument("--train", type=int, default=1280)
    parser.add_argument("--test", type=int, default=256)
    parser.add_argument("--seed", type=int, default=0)
    a = parser.parse_args()
    generate(a.out_dir, a.train, a.test, a.seed)
