"""NUTS constants shared by the kernel, its plain version and the sampler."""

MAX_TREE_DEPTH = 10  # reference nuts.py:4; doublings 0..max_depth
DIVERGENCE_THRESHOLD = 100.0  # nats; reference nuts.py:125
