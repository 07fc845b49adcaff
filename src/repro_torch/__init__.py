"""repro_torch: the tensorized CloudSim of ``repro`` ported to PyTorch and CUDA.

The JAX package ``repro`` is the reference; this package reproduces its event
engine batch-major in PyTorch, with the advance sweep as a hand-written CUDA
kernel for Hopper (``kernels/vm_update.py``, ``csrc/vm_update.cu``).  It
imports neither JAX nor ``repro``.  Entry points run on the GPU unless the
caller passes ``device="cpu"``.
"""
