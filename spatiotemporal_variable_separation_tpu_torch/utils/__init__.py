"""Weight transfer from the JAX package's variables."""
