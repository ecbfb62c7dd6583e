"""Decode kernels of the port: a Hopper kernel and its plain PyTorch
version per module, with the host glue that packs their planes."""
