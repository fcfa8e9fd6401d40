"""The port's fused dropout (kernel B2's plain version and its autograd
rule) against the JAX package's ``ops/dropout_pallas.py`` on the CPU.

The JAX side runs ``_fda`` / ``_fd`` with ``(rate, True)``: the Pallas
kernel in interpret mode, whose bits are the counter hash the port
computes (the TPU's hardware PRNG is not reproducible off the TPU). Same
int32 seed, inputs from numpy with a seed; the outputs and both
cotangents (``jax.vjp``) must be bit-identical, in fp32 and bf16, with M
not a multiple of 256 and a 3-d input. On a CPU tensor the op launches
nothing; tests/test_torch_cuda.py holds the kernel against the plain
version on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_global_state import jax_globals, jax_globals_module  # noqa: F401
from openseq2seq_tpu.ops import dropout_pallas as dp
from openseq2seq_tpu_torch.ops import fused_dropout as fd
from test_torch_text_data import one_thread  # noqa: F401

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _arrays(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


def _bits(a):
    """An array of either framework as fp32 numpy (bf16 upcasts
    exactly)."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("shape,seed", [((600, 256), -987654321),
                                        ((3, 7, 128), 20240607)])
def test_matches_jax_interpret_bit_for_bit(shape, seed, dtype, rate):
    jdt, tdt = DTYPES[dtype]
    y, x, g = _arrays(shape, abs(seed) % 1000)
    js = jnp.array([seed], jnp.int32)
    jy, jx, jg = (jnp.asarray(a).astype(jdt) for a in (y, x, g))
    ty, tx, tg = (torch.from_numpy(a).to(tdt) for a in (y, x, g))

    # with the residual: out, d/dy, d/dx
    want, vjp = jax.vjp(lambda a, b: dp._fda((rate, True), js, a, b), jy, jx)
    want_dy, want_dx = vjp(jg)
    leaves = [t.clone().requires_grad_() for t in (tx, ty)]
    out = fd.fused_dropout_add(leaves[0], leaves[1], rate, seed)
    out.backward(tg)
    assert out.dtype == tdt
    for got, ref in ((out, want), (leaves[1].grad, want_dy),
                     (leaves[0].grad, want_dx)):
        np.testing.assert_array_equal(_bits(got), _bits(ref))
    np.testing.assert_array_equal(
        _bits(fd.fused_dropout_add_plain(tx, ty, rate, seed)), _bits(want))

    # without: out, d/dy
    want, vjp = jax.vjp(lambda a: dp._fd((rate, True), js, a), jy)
    (want_dy,) = vjp(jg)
    leaf = ty.clone().requires_grad_()
    out = fd.fused_dropout(leaf, rate, seed)
    out.backward(tg)
    np.testing.assert_array_equal(_bits(out), _bits(want))
    np.testing.assert_array_equal(_bits(leaf.grad), _bits(want_dy))
    np.testing.assert_array_equal(
        _bits(fd.fused_dropout_plain(ty, rate, seed)), _bits(want))


def test_thr_q_and_keep_rate():
    assert fd.thr_q(0.3) == dp._thr_q(0.3)
    y = torch.ones((512, 256))
    out = fd.fused_dropout_plain(y, 0.3, 7)
    kept = (out != 0).float().mean().item()
    assert abs(kept - 0.7) < 4 * (0.21 / y.numel()) ** 0.5
    np.testing.assert_allclose(out[out != 0].numpy(),
                               1.0 / fd.thr_q(0.3)[1], rtol=1e-6)
    # the seed tensor and the int give the same mask; another seed not
    seed = torch.tensor([7], dtype=torch.int32)
    torch.testing.assert_close(fd.fused_dropout_plain(y, 0.3, seed), out,
                               rtol=0, atol=0)
    assert not torch.equal(fd.fused_dropout_plain(y, 0.3, 8), out)


def test_rate_zero_is_the_identity():
    x, y = torch.randn(4, 128), torch.randn(4, 128)
    torch.testing.assert_close(fd.fused_dropout_add(x, y, 0.0, 1), x + y,
                               rtol=0, atol=0)
    assert fd.fused_dropout(y, 0.0, 1) is y
    assert fd.fused_dropout_plain(y, 0.0, 1) is y


def test_cpu_tensor_runs_plain_without_launch_and_cuda_path_raises():
    y = torch.randn(8, 128, requires_grad=True)
    before = fd.LAUNCHES
    fd.fused_dropout(y, 0.3, 5).sum().backward()
    fd.fused_dropout_add(torch.zeros(8, 128), y.detach(), 0.3, 5)
    assert fd.LAUNCHES == before
    seed = torch.tensor([5], dtype=torch.int32)
    with pytest.raises(ValueError, match="no fused dropout kernel"):
        fd.fused_dropout_cuda(y.detach(), None, 0.3, seed)


def test_draw_seed_is_a_device_int32_from_the_generator():
    g = torch.Generator().manual_seed(3)
    a = fd.draw_seed(g, "cpu")
    b = fd.draw_seed(torch.Generator().manual_seed(3), "cpu")
    assert a.dtype == torch.int32 and a.shape == (1,) and torch.equal(a, b)
    with pytest.raises(ValueError, match="Generator"):
        fd.draw_seed(None, "cpu")
    assert fd.supported((5, 256)) and not fd.supported((5, 200))
