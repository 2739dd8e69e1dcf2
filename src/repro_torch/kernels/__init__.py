"""Hand-written Hopper kernels of the port, one package per TPU kernel of the
reference, each with its plain PyTorch version beside it."""
