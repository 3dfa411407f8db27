"""PyTorch + CUDA port of the desktop-streaming encoder for one NVIDIA H100.

The JAX package ``docker_nvidia_glx_desktop_tpu`` beside this one is the
reference.  This package imports neither JAX nor anything of that package;
it keeps its own copies of the host modules it needs.  The layout mirrors
the reference (``ops/``, ``bitstream/``, ``models/``, ``utils/``,
``obs/``) so each counterpart is found by name.

Each device program of the reference that this package ports is a kernel
written by hand for Hopper (``csrc/*.cu``, built with ``nvcc`` at first
use), with a plain PyTorch version of the same function beside it: the
wrapper runs the plain version for CPU tensors and the kernel for CUDA
tensors.  Entry points run on the card unless the caller asks for the
CPU (``device="cpu"``).
"""
