"""Kernels of the port: plain PyTorch versions (``ref``), the CUDA kernels
and their wrappers (``vm_update``), and routing by device (``ops``)."""
