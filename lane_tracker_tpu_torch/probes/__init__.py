"""Design-space probes of the JAX package's scripts, ported to the card."""
