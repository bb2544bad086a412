"""Quickstart of the PyTorch/CUDA port: write eGPU assembly, launch it on
the multi-SM device, read the aggregate profile.

    PYTHONPATH=src python examples/torch_quickstart.py               # card
    PYTHONPATH=src python examples/torch_quickstart.py --backend cpu # host

The same tour as ``examples/quickstart.py``, on ``repro_torch``. On the
card (the default) every data row runs one of the port's CUDA kernels;
``--backend cpu`` runs their plain PyTorch versions on the host. Without
a card the default raises, as ``backend="cuda"`` does. The cycles printed
are the modeled eGPU's, the same on either backend.

Part 1 — a CUDA-style single-program launch: the grid's thread blocks are
scheduled onto the device's SMs in lockstep waves (blocks beyond ``n_sms``
queue for the next round). Each block owns a private shared memory; all
blocks share one global-memory segment through GLD/GST, and BID gives a
block its grid index.

Part 2 — a multi-program launch: FFT and QRD blocks mixed in ONE grid,
dispatched by the dynamic work-queue scheduler (each SM pulls the next
ready block when it retires its current one — ``PID`` tells a block which
program it is). ``profile()`` reports per-SM and per-program occupancy,
idle time, and global-port contention, plus the static-wave baseline the
dynamic schedule is measured against.
"""
import argparse

import numpy as np

from repro_torch.core import (
    DeviceConfig,
    SMConfig,
    assemble,
    auto_nop,
    check_hazards,
    launch,
)

N_BLOCKS = 4      # grid size: 4 thread blocks ...
N_SMS = 2         # ... on a 2-SM device => 2 scheduling waves
BLOCK = 32        # threads per block
N = N_BLOCKS * BLOCK

# z = 2x + y over global memory, one element per thread; each block also
# folds its chunk with the wavefront SUM unit + thread snooping and commits
# the partial with the paper's single-cycle {w1,d1} store.
ASM = f"""
    BID R7                    // block index
    TDX R1                    // thread index within the block
    LOD R8, #{BLOCK}
    MUL.INT32 R9, R7, R8
    ADD.INT32 R1, R9, R1      // gid = bid*block + tid
    GLD R2, (R1)+0            // x[gid]
    GLD R3, (R1)+{N}          // y[gid]
    LOD.FP32 R4, #2           // alpha = 2.0
    MUL.FP32 R5, R2, R4
    ADD.FP32 R6, R5, R3
    GST R6, (R1)+{2 * N}      // z[gid] back to global
    SUM.FP32 R10, R6, R0      // per-wavefront sums -> lane 0
    ADD.FP32 R11, R10@0, R10@1 {{w1,d1}}  // snoop: fold the 2 wavefronts
    GST R11, (R7)+{3 * N} {{w1,d1}}       // single-cycle partial store
    STOP
"""


def main(backend: str = "cuda"):
    """Part 1; returns the launch's result."""
    text = auto_nop(ASM, n_threads=BLOCK)  # pad the 9-cycle RAW windows
    prog = assemble(text)
    print(f"program: {len(prog)} words; hazards:",
          check_hazards(prog, BLOCK) or "none")

    rng = np.random.default_rng(0)
    x = rng.standard_normal(N).astype(np.float32)
    y = rng.standard_normal(N).astype(np.float32)

    dcfg = DeviceConfig(n_sms=N_SMS, global_mem_depth=4 * N,
                        sm=SMConfig(max_steps=1000), backend=backend)
    res = launch(dcfg, prog, grid=(N_BLOCKS,), block=BLOCK,
                 buffers={"x": x, "y": y,
                          "z": np.zeros(N, np.float32),
                          "partials": np.zeros(N_BLOCKS, np.float32)})

    z = res.buffer("z").cpu().numpy()
    partials = res.buffer("partials").cpu().numpy()
    print(f"grid {res.grid} x block {res.block} on {N_SMS} SMs "
          f"-> {res.n_waves} waves {[int(c) for c in res.wave_cycles]}")
    print("z == 2x+y:", np.allclose(z, 2 * x + y))
    print("block partials ok:",
          np.allclose(partials, z.reshape(N_BLOCKS, BLOCK).sum(axis=1),
                      rtol=1e-5))
    p = res.profile()
    print(f"aggregate cycles: {p['total_cycles']}  by class: "
          f"{ {k: v for k, v in p['by_class'].items() if v} }")
    return res


def mixed_inputs():
    """Part 2's inputs: six FFT-256 signals and three 16x16 matrices."""
    rng = np.random.default_rng(1)
    xs = (rng.standard_normal((6, 256))
          + 1j * rng.standard_normal((6, 256))).astype(np.complex64)
    As = rng.standard_normal((3, 16, 16)).astype(np.float32)
    return xs, As


def main_mixed(backend: str = "cuda"):
    """Part 2: heterogeneous launch under the dynamic block scheduler;
    returns the launch's result."""
    from repro_torch.core.programs import launch_fft_qrd

    xs, As = mixed_inputs()
    # 4 SMs, schedule="dynamic"
    X, Q, R, res = launch_fft_qrd(xs, As, backend=backend)
    print(f"\nmixed launch: {res.n_blocks} blocks "
          f"({dict(zip(res.program_names, np.bincount(res.grid_map).tolist()))}) "
          f"on 4 SMs, schedule={res.schedule}")
    print("FFT ok:", np.allclose(X, np.fft.fft(xs, axis=1), atol=1e-3),
          " QRD ok:",
          np.allclose(np.einsum("bij,bjk->bik", Q, R), As, atol=1e-4))
    p = res.profile()
    print(f"dynamic cycles: {p['total_cycles']}  static-wave baseline: "
          f"{p['static_cycles']}  "
          f"(speedup {p['static_cycles'] / p['total_cycles']:.2f}x)")
    for name, d in p["per_program"].items():
        occ = " ".join(f"{o:.0%}" for o in d["sm_occupancy"])
        print(f"  {name:6s} blocks={d['blocks']} busy={d['busy_cycles']} "
              f"gmem_wait={d['gmem_wait']} per-SM occupancy: {occ}")
    for i, d in enumerate(p["per_sm"]):
        print(f"  SM{i}: busy={d['busy']} wait={d['wait']} "
              f"idle={d['idle']} blocks={d['blocks']}")
    return res


def parse_backend() -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: the kernels on the card (default); cpu: "
                         "their plain versions on the host")
    return ap.parse_args().backend


if __name__ == "__main__":
    backend = parse_backend()
    main(backend)
    main_mixed(backend)
