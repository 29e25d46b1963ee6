"""Hand-written CUDA kernels for Hopper, their plain versions and the glue.

Modules are imported by name (``lzw_tpu_torch.kernels.encode`` etc.);
nothing here builds or loads a kernel at import time.
"""
