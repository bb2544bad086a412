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
from .core.machine import MachineState

# the sequencer fields and counters of a MachineState, host values on both
# sides
_SEQ_FIELDS = ("pc", "ret_stack", "ret_sp", "loop_ctr", "loop_sp", "halted",
               "steps", "cycles", "cycles_by_class")


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


def machine_state_from_numpy(fields, device: torch.device | str = "cpu"
                             ) -> MachineState:
    """A port ``MachineState`` from a mapping of numpy views of a
    reference ``MachineState``'s fields (uint32 ``regs``/``shmem``, bool
    ``oob``, integer sequencer fields and counters)."""
    f = {k: np.asarray(fields[k]) for k in ("regs", "shmem", "oob")
         + _SEQ_FIELDS}
    scalar = lambda k: f[k].item()  # noqa: E731
    return MachineState(
        regs=_words(f["regs"], device), shmem=_words(f["shmem"], device),
        oob=torch.from_numpy(f["oob"].astype(bool).copy()).to(device),
        pc=int(scalar("pc")), ret_stack=f["ret_stack"].astype(np.int64),
        ret_sp=int(scalar("ret_sp")),
        loop_ctr=f["loop_ctr"].astype(np.int64),
        loop_sp=int(scalar("loop_sp")), halted=bool(scalar("halted")),
        steps=int(scalar("steps")), cycles=int(scalar("cycles")),
        cycles_by_class=f["cycles_by_class"].astype(np.int64))


def machine_state_to_numpy(state: MachineState) -> dict[str, np.ndarray]:
    """A port ``MachineState`` as numpy arrays: uint32 words, bool ``oob``
    and int64 sequencer fields and counters, comparable with ``==`` to
    ``np.asarray`` of the reference's fields."""
    out = {"regs": _u32(state.regs), "shmem": _u32(state.shmem),
           "oob": state.oob.detach().cpu().numpy().astype(bool)}
    for k in _SEQ_FIELDS:
        out[k] = np.asarray(getattr(state, k)).astype(
            bool if k == "halted" else np.int64)
    return out
