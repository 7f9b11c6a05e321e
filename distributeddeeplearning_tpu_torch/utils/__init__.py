"""Utilities of the port: carrying weights across from the JAX package."""
