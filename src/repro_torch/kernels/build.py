"""Build and load the hand-written CUDA kernels, and count their launches.

The sources in ``csrc/`` have a plain C interface. At first use each one
is compiled by ``nvcc`` for ``sm_90a`` into its own shared library under
``build/repro_torch_kernels/`` at the root of the checkout (one ``nvcc``
per source, all started together) and loaded with ``ctypes``. A library
is named by a hash of its source, the shared header and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.

Nothing here runs when the module is imported: the CPU tests import every
module on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-fmad=false",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
HEADERS = ("egpu_fp32.cuh", "egpu_load_row.cuh", "egpu_row.cuh",
           "egpu_smem.cuh", "hopper_ptx.cuh")
# a block may use at most 227 KiB of shared memory on Hopper
MAX_DYNAMIC_SMEM = 232_448

_P, _I = ctypes.c_void_p, ctypes.c_int
# a data row's 15 fields in FIELDS order and the wave's block size, by value
_ROW = (_I,) * 16
# C entry point -> (library, argument types); every entry point returns
# the cudaError_t of its launch
_ENTRY_POINTS = {
    "egpu_segment": ("segment", (_P, _P, _I, _I, _P, _P, _P, _P, _P, _P,
                                 _P, _P, _I, _I, _I, _I, _I, _P)),
    "egpu_gather_shared": ("gmem", (_P, _I, _P, _P, _P, _P, _I, _P)),
    "egpu_scatter_shared": ("gmem", (_P, _I, _P, _P, _P, _P, _I, _P)),
    "egpu_gld_row": ("gmem", _ROW + (_P, _P, _P, _I, _I, _P)),
    "egpu_gst_row": ("gmem", _ROW + (_P, _P, _P, _I, _I, _P, _P)),
    "egpu_alu": ("alu", (_I, _I, _P, _P, _P, _P, _P, _I, _P)),
    "egpu_alu_row": ("alu", _ROW + (_P, _I, _P)),
    "egpu_gather": ("smem", (_P, _I, _P, _P, _P, _P, _I, _I, _P)),
    "egpu_scatter": ("smem", (_P, _I, _P, _P, _P, _I, _I, _P)),
    "egpu_sto_row": ("smem", _ROW + (_P, _P, _P, _I, _I, _I, _P)),
    "egpu_lod_row": ("smem", _ROW + (_P, _P, _P, _I, _I, _I, _P)),
    "egpu_wavefront_dot": ("dot", (_I, _P, _P, _P, _P, _I, _P)),
    "egpu_fft_r2": ("fft", (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P)),
    "egpu_mgs_qrd": ("qrd", (_P, _P, _P, _I, _I, _P)),
    "egpu_flash_attention": ("flash", (_I, _P, _P, _P, _P, _I, _I, _I, _I,
                                       _I, _I, _I, _P)),
}

# launches per kernel since the last reset: each wrapper adds one where it
# launches its kernel, and nowhere else
launches = {"segment": 0, "gather_shared": 0, "scatter_shared": 0,
            "alu": 0, "gather": 0, "scatter": 0,
            "dot": 0, "fft": 0, "qrd": 0, "flash": 0}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[str, ctypes._CFuncPtr] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for part in [CSRC / f"{name}.cu"] + [CSRC / x for x in HEADERS]:
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source that has no library yet, all in parallel.
    Returns library paths by source name; ``ptxas -v`` output is kept
    beside each library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    names = sorted({lib for lib, _ in _ENTRY_POINTS.values()})
    paths = {n: _lib_path(n) for n in names}
    procs = []
    for n in names:
        if paths[n].exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
               str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for n, tmp, p in procs:
        out, _ = p.communicate()
        paths[n].with_suffix(".log").write_text(out)
        if p.returncode:
            os.unlink(tmp)
            failed.append(f"{n}.cu:\n{out}")
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return paths


def entry_point(fn: str):
    """The ctypes function ``fn``, building and loading its library at
    first use; later calls return the same function object."""
    got = _fns.get(fn)
    if got is not None:
        return got
    lib_name, argtypes = _ENTRY_POINTS[fn]
    with _lock:
        if lib_name not in _libs:
            lib = ctypes.CDLL(str(build_all()[lib_name]))
            for f, (ln, at) in _ENTRY_POINTS.items():
                if ln == lib_name:
                    getattr(lib, f).argtypes = list(at)
                    getattr(lib, f).restype = ctypes.c_int
                    _fns[f] = getattr(lib, f)
            _libs[lib_name] = lib
    return _fns[fn]


def check(err: int, what: str) -> None:
    """Raise if a launch was refused (``cudaGetLastError`` after it)."""
    if err:
        raise RuntimeError(f"{what} launch failed: cudaError_t {err}")


def check_tensor(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``, as a kernel takes its arguments."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                         f"{tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, want {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def current_stream(device: torch.device) -> int:
    """The handle of PyTorch's current stream on ``device``, a CUDA device
    with its index, as a tensor's (read without building a Stream
    object)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def launch(fn: str, count: str, device: torch.device, *args) -> None:
    """Launch the C entry point ``fn`` with ``args`` on ``device``, where
    its tensors lie: on that device's current stream, with the device made
    current for the call (a kernel launches on the current device, and the
    raised shared-memory limits are kept per device). Raises if the launch
    was refused; counts it in ``launches[count]``.

    Entering ``torch.cuda.device`` costs the host a few microseconds a
    launch, so it is entered only when ``device`` is not already current."""
    f = entry_point(fn)
    if device.index == torch.cuda.current_device():
        err = f(*args, current_stream(device))
    else:
        with torch.cuda.device(device):
            err = f(*args, current_stream(device))
    check(err, count)
    launches[count] += 1
