"""eGPU assembly programs: the paper's benchmarks + extras.

Each module also exposes a ``*_kernel`` helper packaging the program as a
``device.Kernel`` for multi-program launches; ``mixed.launch_fft_qrd``
runs two programs in one launch and ``reduction.launch_reduction``'s
``fused=True`` form shows dependent kernels (barrier) in one launch. The
``run_*`` shims run one SM on the step engine.
"""
from .cholesky import (
    cholesky_asm,
    cholesky_imem_depth,
    cholesky_kernel,
    cholesky_shmem,
    run_cholesky,
    run_cholesky_batch,
)
from .fft import (
    bitrev_indices,
    fft_asm,
    fft_kernel,
    fft_program,
    fft_shmem,
    run_fft,
    run_fft_batch,
)
from .masked_reduction import launch_masked_reduction, masked_reduction_asm
from .mixed import launch_fft_qrd, mixed_device
from .qrd import (
    qrd_asm,
    qrd_asm_loop,
    qrd_kernel,
    qrd_program,
    qrd_shmem,
    run_qrd,
    run_qrd_batch,
)
from .reduction import launch_reduction, reduction_asm, run_reduction
from .saxpy import (
    launch_saxpy,
    run_saxpy,
    saxpy_asm,
    saxpy_grid_asm,
    saxpy_kernel,
    saxpy_program,
)

__all__ = [
    "bitrev_indices", "fft_asm", "fft_kernel", "fft_program", "fft_shmem",
    "run_fft", "run_fft_batch",
    "cholesky_asm", "cholesky_imem_depth", "cholesky_kernel", "cholesky_shmem", "run_cholesky",
    "run_cholesky_batch",
    "launch_fft_qrd", "mixed_device",
    "launch_masked_reduction", "masked_reduction_asm",
    "qrd_asm", "qrd_asm_loop", "qrd_kernel", "qrd_program", "qrd_shmem",
    "run_qrd", "run_qrd_batch",
    "launch_reduction", "reduction_asm", "run_reduction",
    "launch_saxpy", "run_saxpy", "saxpy_asm", "saxpy_grid_asm",
    "saxpy_kernel", "saxpy_program",
]
