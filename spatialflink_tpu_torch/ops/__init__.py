"""Device ops: plain PyTorch math and the wrappers of the CUDA kernels."""
