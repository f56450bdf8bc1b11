"""Hand-written CUDA kernels (sources in ``bert4clickpath_torch/csrc``).

Each module holds one kernel's wrapper and its plain PyTorch version. A
wrapper takes the plain version only for tensors that lie on the CPU; on a
CUDA tensor it launches the kernel or raises.
"""
