"""Hand-written CUDA kernels of the port, their wrappers and their plain
PyTorch versions: the launch path's (modules ``simt_alu``, ``simt_step``)
and the kernel layer's (``wavefront_dot``, ``fft_r2``, ``mgs_qrd``,
``flash_attention``), with ``ops`` the public entry points, ``ref`` the
plain arithmetic and ``build`` the lazy build with the launch counters.

The kernel layer's four wrappers are exported under their modules' names,
as the reference exports them. ``simt_alu`` stays the module (the core's
execute backends take the wrapper and its plain version from it); its
wrapper is ``simt_alu.simt_alu``.
"""
from . import ops, ref, simt_alu
from .fft_r2 import fft_r2
from .flash_attention import flash_attention
from .mgs_qrd import mgs_qrd
from .ref import flash_attention_ref
from .wavefront_dot import wavefront_dot

__all__ = ["ops", "ref", "fft_r2", "flash_attention",
           "flash_attention_ref", "mgs_qrd", "simt_alu", "wavefront_dot"]
