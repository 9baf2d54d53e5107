"""Host-to-device loading for the port (decode reuses the JAX package's
JAX-free host code)."""
