"""Batched linear solver via MGS QRD on the PyTorch/CUDA port — the
paper's motivating workload ("the linear solvers commonly used in
wireless systems", §I).

    PYTHONPATH=src python examples/torch_qrd_solver.py               # card
    PYTHONPATH=src python examples/torch_qrd_solver.py --backend cpu # host

Solves Ax = b for a batch of 16x16 systems three ways, as
``examples/qrd_solver.py`` does:
  1. the simulated eGPU running the paper's assembly on one SM (the step
     engine; on the card each data row is one of the port's CUDA kernels),
  2. ``kernels.ops.qrd`` (the ``mgs_qrd`` CUDA kernel) and a triangular
     back-substitution,
  3. numpy (the oracle),
and reports their agreement and the modeled eGPU cycles per solve at the
paper's 771 MHz. ``--backend cpu`` runs the plain PyTorch versions on the
host; without a card the default raises.
"""
import numpy as np

from repro_torch.core import profile, resources
from repro_torch.core.programs.qrd import run_qrd
from repro_torch.kernels import ops

# a solve agrees with numpy's within this (A + 4 I is well conditioned)
TOL = 1e-3


def back_substitute(r, y):
    """Solve R x = y for upper-triangular R. r: (B,n,n), y: (B,n)."""
    B, n, _ = r.shape
    x = np.zeros((B, n), np.float64)
    r = np.asarray(r, np.float64)
    y = np.asarray(y, np.float64)
    for i in range(n - 1, -1, -1):
        x[:, i] = (y[:, i] - np.einsum("bj,bj->b", r[:, i, i + 1:],
                                       x[:, i + 1:])) / r[:, i, i]
    return x


def systems(B: int = 32, n: int = 16):
    rng = np.random.default_rng(0)
    A = rng.standard_normal((B, n, n)).astype(np.float32)
    A += 4 * np.eye(n, dtype=np.float32)   # well-conditioned
    b = rng.standard_normal((B, n)).astype(np.float32)
    return A, b


def main(backend: str = "cuda"):
    """Run the three solvers; returns the eGPU run's final state."""
    A, b = systems()

    # kernel layer (batched)
    device = "cpu" if backend == "cpu" else None
    q, r = ops.qrd(A, device=device)
    q, r = q.cpu().numpy(), r.cpu().numpy()
    y = np.einsum("bij,bi->bj", q, b)                # Q^T b
    x_kernel = back_substitute(r, y)

    # the simulated eGPU (the paper's machine, one matrix)
    q0, r0, st = run_qrd(A[0], backend=backend)
    y0 = q0.T @ b[0]
    x_iss = back_substitute(r0[None], y0[None])[0]

    # oracle
    x_np = np.stack([np.linalg.solve(A[i], b[i]) for i in range(len(A))])

    err_k = float(np.abs(x_kernel - x_np).max())
    err_i = float(np.abs(x_iss - x_np[0]).max())
    print("kernel max |x - x_np|:", err_k)
    print("eGPU max |x - x_np| (matrix 0):", err_i)
    print("kernel solve ok:", err_k < TOL, " eGPU solve ok:", err_i < TOL)
    p = profile(st)
    cyc = p["total_cycles"]
    us = cyc / resources.fmax_mhz(1)      # cycles / MHz = microseconds
    print(f"eGPU QRD: {cyc} cycles = {us:.1f} us at 771 MHz "
          f"(hard GPUs hit single-digit % efficiency at this size — paper "
          f"[24,25])")
    print(f"by class: { {k: v for k, v in p['by_class'].items() if v} }")
    return st


if __name__ == "__main__":
    from torch_quickstart import parse_backend

    main(parse_backend())
