"""Signal pipeline of the PyTorch/CUDA port: windowed FFT spectral
analysis on the simulated eGPU and on the kernel layer.

    PYTHONPATH=src python examples/torch_fft_pipeline.py               # card
    PYTHONPATH=src python examples/torch_fft_pipeline.py --backend cpu # host

The same pipeline as ``examples/fft_pipeline.py``, on ``repro_torch``: the
eGPU runs the paper's FFT-256 on one SM (the step engine; on the card each
data row is one of the port's CUDA kernels), and ``kernels.ops.fft`` runs
a batch of 16 windows through the ``fft_r2`` CUDA kernel. ``--backend
cpu`` runs the plain PyTorch versions on the host instead; without a card
the default raises. The cycles and microseconds printed are the modeled
eGPU's at the paper's 771 MHz, the same on either backend.
"""
import numpy as np

from repro_torch.core import profile, resources
from repro_torch.core.programs.fft import run_fft
from repro_torch.kernels import ops


def signal(n: int = 256) -> np.ndarray:
    """Two tones and noise."""
    rng = np.random.default_rng(0)
    t = np.arange(n) / n
    return (np.sin(2 * np.pi * 17 * t) + 0.5 * np.sin(2 * np.pi * 49 * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def main(backend: str = "cuda"):
    """Run the pipeline; returns the eGPU run's final state."""
    sig = signal()
    n = sig.shape[0]

    # eGPU path: one SM
    X, st = run_fft(sig.astype(np.complex64), backend=backend)
    mag = np.abs(X[: n // 2])
    peaks = sorted(int(p) for p in np.argsort(mag)[-2:])
    print("eGPU FFT peak bins:", peaks, "(expected [17, 49])")
    print("peaks ok:", peaks == [17, 49])
    p = profile(st)
    us = p["total_cycles"] / resources.fmax_mhz(1)
    share = (p["by_class"]["LOD_IDX"] + p["by_class"]["STO_IDX"]) \
        / p["total_cycles"]
    print(f"eGPU cycles={p['total_cycles']} = {us:.1f}us @771MHz; "
          f"shared-memory share = {share:.0%} (paper: 75%)")
    print(f"by class: { {k: v for k, v in p['by_class'].items() if v} }")

    # kernel layer: a batch of 16 windows through fft_r2
    frames = np.stack([sig] * 16)
    device = "cpu" if backend == "cpu" else None
    fr, fi = ops.fft(frames, np.zeros_like(frames), device=device)
    fr, fi = fr.cpu().numpy(), fi.cpu().numpy()
    kmag = np.abs(fr[0, : n // 2] + 1j * fi[0, : n // 2])
    print("kernel/ISS spectra agree:",
          np.allclose(kmag, mag, atol=1e-3 * mag.max()))
    return st


if __name__ == "__main__":
    from torch_quickstart import parse_backend

    main(parse_backend())
