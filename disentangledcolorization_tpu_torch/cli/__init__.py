"""Command-line entry points (counterparts of the JAX package's ``cli``)."""
