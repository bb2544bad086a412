"""eGPU assembly programs ported with the megakernel slice: grid SAXPY
(global-memory GLD/GST), the radix-2 FFT and the 16x16 MGS QRD."""
from .fft import bitrev_indices, fft_asm, fft_program, fft_shmem, run_fft_batch
from .qrd import qrd_asm, qrd_asm_loop, qrd_program, qrd_shmem, run_qrd_batch
from .saxpy import launch_saxpy, saxpy_grid_asm, saxpy_kernel

__all__ = [
    "bitrev_indices", "fft_asm", "fft_program", "fft_shmem", "run_fft_batch",
    "qrd_asm", "qrd_asm_loop", "qrd_program", "qrd_shmem", "run_qrd_batch",
    "launch_saxpy", "saxpy_grid_asm", "saxpy_kernel",
]
