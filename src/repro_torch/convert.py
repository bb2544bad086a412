"""State carry-across between the JAX reference and the port.

The reference keeps architectural words as ``uint32`` and the per-SM
out-of-range flags as ``bool``; the port keeps words as ``torch.int32``
(the same bits) on the device of its backend. Program words are plain
``int64`` numpy arrays in both packages and cross over unchanged.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.device import DeviceState, LaunchResult


def _words(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a), dtype=np.uint32)
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().view(np.uint32)


def state_from_numpy(regs, shmem, gmem, oob,
                     device: torch.device | str = "cpu") -> DeviceState:
    """A port ``DeviceState`` from uint32 ``regs`` (n, 512, 16), ``shmem``
    (n, depth), ``gmem`` (gdepth,) and bool ``oob`` (n,)."""
    return DeviceState(
        regs=_words(regs, device), shmem=_words(shmem, device),
        gmem=_words(gmem, device),
        oob=torch.from_numpy(np.asarray(oob, bool).copy()).to(device))


def state_to_numpy(state: DeviceState) -> dict[str, np.ndarray]:
    """The data state of a port ``DeviceState`` as uint32/bool arrays."""
    return {"regs": _u32(state.regs), "shmem": _u32(state.shmem),
            "gmem": _u32(state.gmem),
            "oob": state.oob.detach().cpu().numpy().astype(bool)}


def launch_result_to_numpy(res: LaunchResult) -> dict[str, np.ndarray]:
    """A port ``LaunchResult``'s architectural state as uint32/bool arrays,
    comparable with ``==`` to ``np.asarray`` of the reference's fields."""
    return {"regs": _u32(res.regs), "shmem": _u32(res.shmem),
            "gmem": _u32(res.gmem),
            "oob": res.oob.detach().cpu().numpy().astype(bool)}
