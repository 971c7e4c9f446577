"""The serial NumPy oracle (`numpy_smc`), a CPU yardstick; imports no jax."""
