"""Hand-written CUDA kernels for Hopper (``csrc/``), with their wrappers.

Each wrapper runs its plain PyTorch version on CPU tensors and launches its
kernel on CUDA tensors, counting the launches in ``<wrapper>.launches``.
"""
