"""openseq2seq_tpu_torch — the PyTorch and CUDA port of openseq2seq_tpu.

The package mirrors ``openseq2seq_tpu``'s layout and names module for
module, in PyTorch idiom: ``nn.Module``s and plain functions on tensors,
an explicit device passed through the model, and seeded
``torch.Generator``s for initialisation. Every TPU (Pallas) kernel of
the JAX package becomes a hand-written kernel for NVIDIA Hopper under
``csrc/``, built at first use (``kernels/build.py``). It reuses the JAX
package's host modules that import no JAX (data layers, config and
params plumbing, logging, metrics), and imports neither jax nor flax.

Ported so far: Jasper (TDNN encoder, CTC decoder and loss) for eval and
infer, run as ``python -m openseq2seq_tpu_torch.run``.
"""

__version__ = "0.1.0"
