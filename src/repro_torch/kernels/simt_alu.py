"""The step path's ALU kernel: wrapper and plain version.

``simt_alu`` executes one ALU instruction (INT32/UINT32 add, sub, 16x16
multiply, and/or/xor/not, lsl/lsr; FP32 add/sub/mul) over an SM batch of
pre-gathered operand tiles; lanes outside the mask keep ``old``
(CUDA: ``csrc/alu.cu``; plain: ``alu_plain``).

A wrapper takes the plain version only because the tensors it was given
lie on the host. For tensors on the card it launches its kernel (on the
current stream, without synchronising) or raises; it never falls back.
Words are ``torch.int32``; masks are ``torch.bool``.
"""
from __future__ import annotations

import torch

from . import build, ref
from .simt_step import _check, _stream


def alu_plain(op: int, typ: int, a, b, mask, old):
    """``ref.alu_ref`` where ``mask``, else ``old``."""
    return torch.where(mask, ref.alu_ref(op, typ, a, b), old)


def check_alu_args(op: int, typ: int, a, b, mask, old) -> None:
    """Raise unless the ALU kernel takes these arguments as they are."""
    if not 1 <= op <= 9:
        raise ValueError(f"op={op} is not an ALU opcode")
    dev = a.device
    for t, name, dt in ((a, "a", torch.int32), (b, "b", torch.int32),
                        (mask, "mask", torch.bool), (old, "old", torch.int32)):
        _check(t, name, dt, old.shape, dev)


def simt_alu(op: int, typ: int, a, b, mask, old):
    """One ALU instruction. ``op`` (1..9) and ``typ`` (0 INT32, 1 UINT32,
    2 FP32) are host integers; ``a``, ``b``, ``old`` (n, 512) int32;
    ``mask`` (n, 512) bool. Returns the new destination column."""
    if not a.is_cuda:
        return alu_plain(op, typ, a, b, mask, old)
    check_alu_args(op, typ, a, b, mask, old)
    out = torch.empty_like(old)
    fn = build.entry_point("egpu_alu")
    build.check(fn(int(op), int(typ), a.data_ptr(), b.data_ptr(),
                   mask.data_ptr(), old.data_ptr(), out.data_ptr(),
                   old.numel(), _stream()), "alu")
    build.launches["alu"] += 1
    return out
