"""ops subpackage: plain PyTorch versions and the wrappers of the CUDA kernels."""
