"""Hand-written Hopper kernels (``csrc/``) with their plain torch versions."""
