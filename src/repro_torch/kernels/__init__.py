"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version; ``build`` compiles and binds them at first use."""
