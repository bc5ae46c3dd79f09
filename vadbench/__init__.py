"""The PyTorch/CUDA port's benchmark."""
