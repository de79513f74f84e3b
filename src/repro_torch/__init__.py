"""SPARTan PARAFAC2 in PyTorch, with hand-written CUDA kernels for Hopper.

A module-for-module port of the JAX package ``repro``: ``repro_torch.core.
parafac2`` is held against ``repro.core.parafac2`` and so on. It imports
``torch`` and numpy only. See ``repro_torch.launch.decompose`` for the entry
point, ``repro_torch.kernels.fused`` for the fused kernels and
``repro_torch.kernels.ops`` for the staged ones.
"""
