"""eGPU on PyTorch and CUDA: the multi-SM device simulator of the JAX
package under ``src/repro/``, ported to one NVIDIA H100.

Launches run on the card by default (``backend="cuda"``: state in device
memory, hand-written CUDA kernels from ``kernels/csrc``); ``backend="cpu"``
runs the same launch on the host through the kernels' plain PyTorch
versions. See ``core`` for the public API.
"""
