"""SMC primitives and the NUTS proposal."""
