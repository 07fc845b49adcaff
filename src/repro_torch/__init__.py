"""repro_torch: the tensorized CloudSim of ``repro`` ported to PyTorch and CUDA.

The JAX package ``repro`` is the reference; this package reproduces its event
engine batch-major in PyTorch, its serving stack and its training loop, with
each of the reference's TPU kernels as a hand-written CUDA kernel for Hopper
(``csrc/``: the advance sweep, flash attention, the Mamba2 SSD scan).  It
imports neither JAX nor ``repro``.  Entry points run on the GPU unless the
caller passes ``device="cpu"``.
"""
