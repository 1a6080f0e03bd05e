"""Hand-written device kernels of the PyTorch port."""
