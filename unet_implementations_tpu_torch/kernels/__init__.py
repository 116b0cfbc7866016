"""Hand-written CUDA kernels for Hopper (``csrc/``), with their wrappers.

Each wrapper runs its plain PyTorch version on CPU tensors and launches its
kernel on CUDA tensors, counting the launches in ``<wrapper>.launches``. K1's
forward, K2a, K2b and K3 are operators of the ``unet_torch`` namespace
(``torch.ops.unet_torch``), registered when their module is imported, so
that ``torch.export`` captures them and an exported program replays them.
"""
