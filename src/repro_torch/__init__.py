"""PyTorch/CUDA port of the AraOS paged-KV serving stack.

A second package beside the JAX reference (``src/repro``), with the same
layout (``configs/``, ``core/``, ``kernels/``, ``models/``, ``serve/``,
``launch/``).  It imports no JAX and nothing of the JAX package.  Entry
points run on the CUDA card unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve_device`); every Pallas kernel of the
JAX package is a hand-written CUDA kernel for Hopper under
``kernels/csrc``.
"""
