"""Hand-written CUDA kernels of the port, their wrappers and their plain
PyTorch versions (``simt_step``), the plain arithmetic (``ref``), and the
lazy build with the launch counters (``build``)."""
