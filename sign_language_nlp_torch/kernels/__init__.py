"""Build and ctypes binding of the CUDA sources in csrc/."""
