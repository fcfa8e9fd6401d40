"""The port's image data layers against the JAX package's on the same
files and seed: every batch of an epoch equal (images, labels, ids,
``batch_valid``), in training (shuffle and augmentation from the layer's
seeded ``RandomState``) and in eval. CIFAR on ``test_utils/fake_cifar``'s
binary records, ImageNet on ``test_utils/fake_imagenet``'s JPEG tree and
TFRecord shard (those two need Pillow), the synthetic layer; and the fake
CIFAR set's ten classes survive the layer's flip and crop."""
import numpy as np
import pytest

from openseq2seq_tpu.data import image2label as jax_image
from openseq2seq_tpu.data.synthetic import \
    SyntheticImageDataLayer as JaxSynthetic
from openseq2seq_tpu_torch.data import image2label as torch_image
from openseq2seq_tpu_torch.data.synthetic import SyntheticImageDataLayer
from openseq2seq_tpu_torch.test_utils import fake_cifar
from test_torch_text_data import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def cifar_dir(tmp_path_factory):
    return fake_cifar.generate(str(tmp_path_factory.mktemp("cifar")),
                               n_train=40, n_test=12, seed=3)


@pytest.fixture(scope="module")
def imagenet_dir(tmp_path_factory):
    pytest.importorskip("PIL")
    from openseq2seq_tpu_torch.test_utils import fake_imagenet
    return fake_imagenet.generate(str(tmp_path_factory.mktemp("imagenet")),
                                  num_classes=3, per_class=2)


def _epochs(jax_cls, torch_cls, params, seed, n_epochs=1):
    layers = []
    for cls in (jax_cls, torch_cls):
        layer = cls(dict(params), model=None)
        layer.seed(seed)
        layers.append(layer)
    out = []
    for _ in range(n_epochs):
        out.append([list(layer.iterate_one_epoch()) for layer in layers])
    return out


def _assert_same(want_batches, got_batches):
    assert len(want_batches) == len(got_batches) > 0
    for want, got in zip(want_batches, got_batches):
        assert set(want) == set(got)
        for key in want:
            w, g = want[key], got[key]
            if isinstance(w, list):
                for a, b in zip(w, g):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_array_equal(w, g)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_cifar_batches_equal_jax(cifar_dir, mode):
    params = {"mode": mode, "data_dir": cifar_dir, "batch_size": 16}
    for want, got in _epochs(jax_image.CifarDataLayer,
                             torch_image.CifarDataLayer, params, seed=7,
                             n_epochs=2):
        _assert_same(want, got)
        assert got[0]["source_tensors"][0].shape == (16, 32, 32, 3)
    # the last batch is padded and says how much of it is valid
    assert int(got[-1]["batch_valid"]) == (40 if mode == "train" else 12) \
        % 16


@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("layer", ["ImagenetDataLayer",
                                   "ImagenetTFRecordDataLayer"])
def test_imagenet_batches_equal_jax(imagenet_dir, layer, mode):
    params = {"mode": mode, "data_dir": imagenet_dir, "batch_size": 4,
              "image_size": 64}
    (want, got), = _epochs(getattr(jax_image, layer),
                           getattr(torch_image, layer), params, seed=2)
    _assert_same(want, got)
    assert got[0]["source_tensors"][0].shape == (4, 64, 64, 3)
    labels = np.concatenate([b["target_tensors"][0] for b in got])
    assert set(labels.tolist()) == {0, 1, 2}


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_synthetic_images_equal_jax(mode):
    params = {"mode": mode, "num_classes": 10, "image_size": 8,
              "num_batches": 2, "batch_size": 3}
    (want, got), = _epochs(JaxSynthetic, SyntheticImageDataLayer, params, 0)
    _assert_same(want, got)


def test_fake_cifar_classes_survive_augmentation(cifar_dir):
    """Each class keeps its stripe orientation and period through the
    train layer's crop and flip: the dominant spatial frequency of an
    image's mean over channels, along rows for even classes and along
    columns for odd ones, is its class's."""
    layer = torch_image.CifarDataLayer(
        {"mode": "train", "data_dir": cifar_dir, "batch_size": 40}, None)
    layer.seed(0)
    batch = next(iter(layer.iterate_one_epoch()))
    x, y = batch["source_tensors"][0], batch["target_tensors"][0]
    assert set(y.tolist()) == set(range(fake_cifar.NUM_CLASSES))
    for img, label in zip(x, y):
        gray = img.mean(-1)
        profile = gray.mean(1) if label % 2 == 0 else gray.mean(0)
        spectrum = np.abs(np.fft.rfft(profile - profile.mean()))
        period = 2 ** (label // 2 + 1)
        assert np.argmax(spectrum) == 32 // period, (label, spectrum)
