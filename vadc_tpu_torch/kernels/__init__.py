"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version. Sources are in csrc/; kernels/_build.py compiles them with nvcc at
first use. Importing these modules builds nothing."""
