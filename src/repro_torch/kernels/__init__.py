"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions and the
dispatchers that pick between them by the device of their inputs."""
