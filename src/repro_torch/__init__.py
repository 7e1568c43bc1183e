"""EdgeKV in PyTorch: the port of the JAX package ``repro`` to PyTorch and
CUDA on an NVIDIA H100.

Module for module it mirrors ``repro`` (``core/``, ``obs/``, ``sim/``,
``fault/``, ``kernels/``), so each part's counterpart is found by path.
It imports ``torch`` and ``numpy``, never ``jax`` or ``repro``.  Entry
points run on the GPU unless the caller passes ``device="cpu"``.
"""
