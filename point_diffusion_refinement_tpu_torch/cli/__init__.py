"""Command-line helpers of the port (counterpart of the JAX package's ``cli/``)."""
