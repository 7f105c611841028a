"""Kernels of the port: each TPU kernel re-written by hand for Hopper,
beside its plain PyTorch version."""
