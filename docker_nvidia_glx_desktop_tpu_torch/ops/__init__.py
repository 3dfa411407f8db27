"""Device ops of the port: each ported TPU program is a hand-written CUDA
kernel (``csrc/``) with its plain PyTorch version beside it."""
