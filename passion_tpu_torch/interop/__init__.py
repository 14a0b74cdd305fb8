"""Weight interchange with the JAX package (numpy in, torch out)."""
