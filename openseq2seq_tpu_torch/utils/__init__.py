"""Host utilities: the port's own copies of the JAX package's jax-free
``utils`` modules."""
