"""Kernels of the port: plain PyTorch versions (``ref``), the CUDA kernels
and their wrappers (``vm_update``, ``flash_attention``, ``ssd_scan``), the
shared nvcc build (``build``), and routing by device (``ops``)."""
