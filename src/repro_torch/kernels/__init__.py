"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``).

Layout: ``<name>.py`` holds a kernel's wrapper (checks, launch, launch
counter), ``csrc/<name>.cu`` its source, ``ref.py`` the plain PyTorch
versions, ``ops.py`` the dispatch by device, ``build.py`` the nvcc build.
"""
