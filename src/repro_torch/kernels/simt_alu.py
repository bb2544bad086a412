"""The step path's ALU kernel: wrappers and plain versions.

Two entry points share one kernel body (CUDA: ``csrc/alu.cu``):

  * ``simt_alu_row`` — one ALU data row of the step and trace engines over
    an SM batch's register file: operands (snooped or not), the active
    shape and the predicate gate are read on the card, and the
    destination register is written in place; one launch per row (plain:
    ``alu_row_plain``, out of place);
  * ``simt_alu`` — one ALU instruction (INT32/UINT32 add, sub, 16x16
    multiply, and/or/xor/not, lsl/lsr; FP32 add/sub/mul) over
    pre-gathered operand tiles; lanes outside the mask keep ``old``
    (plain: ``alu_plain``; ``ops.alu``).

A wrapper takes the plain version only because the tensors it was given
lie on the host. For tensors on the card it launches its kernel (on the
current stream, without synchronising) or raises; it never falls back.
Words are ``torch.int32``; masks are ``torch.bool``.
"""
from __future__ import annotations

import torch

from . import build, ref
from .build import check_tensor


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
        check_tensor(t, name, dt, old.shape, dev)


def simt_alu(op: int, typ: int, a, b, mask, old):
    """One ALU instruction. ``op`` (1..9) and ``typ`` (0 INT32, 1 UINT32,
    2 FP32) are host integers; ``a``, ``b``, ``old`` (n, 512) int32;
    ``mask`` (n, 512) bool. Returns the new destination column."""
    if not a.is_cuda:
        return alu_plain(op, typ, a, b, mask, old)
    check_alu_args(op, typ, a, b, mask, old)
    out = torch.empty_like(old)
    build.launch("egpu_alu", "alu", a.device, int(op), int(typ), a.data_ptr(),
                 b.data_ptr(), mask.data_ptr(), old.data_ptr(), out.data_ptr(),
                 old.numel())
    return out


# ---------------------------------------------------------------------------
# one ALU data row of the step and trace engines
# ---------------------------------------------------------------------------

def alu_row_plain(cfg, row, regs, alu=alu_plain):
    """One ALU row (``row`` a ``core.executor.FusedRow``) over ``regs``
    (n, 512, 16) int32: ``ref.alu_ref`` of the row's operands where the
    row's write mask holds, else the old destination. ``alu`` is the
    per-op function (``simt_alu``'s signature) that computes the new
    destination column. ``regs`` is not modified; returns the new
    register file."""
    # the core's executor imports this module: take its row view at call
    # time, so that either may be imported first
    from ..core.executor import row_eff, row_operand

    d = row.d
    res = alu(d["opcode"], d["typ"],
                    row_operand(row, regs, d["ra"], d["ext_a"]),
                    row_operand(row, regs, d["rb"], d["ext_b"]),
                    row_eff(cfg.n_threads, row, regs),
                    regs[:, :, d["rd"]].contiguous())
    out = regs.clone()
    out[:, :, d["rd"]] = res
    return out


def check_regs(regs) -> None:
    """Raise unless ``regs`` is a register file as the row kernels take
    it: (n, 512, 16) int32, contiguous."""
    from ..core.machine import MAX_THREADS, N_REGS

    check_tensor(regs, "regs", torch.int32,
                 (regs.shape[0], MAX_THREADS, N_REGS), regs.device)


def check_alu_row_args(cfg, row, regs) -> tuple:
    """Raise unless the ALU row kernel takes these arguments as they
    are; returns the row's fields in ``FIELDS`` order."""
    fields = row.fields
    if not 1 <= row.d["opcode"] <= 9:
        raise ValueError(f"opcode={row.d['opcode']} is not an ALU opcode")
    check_regs(regs)
    return fields


def simt_alu_row(cfg, row, regs):
    """One ALU row over the register file ``regs`` (n, 512, 16) int32 of
    a wave of ``cfg.n_threads``-thread blocks. On the card ``regs`` is
    written in place (one launch) and returned."""
    if not regs.is_cuda:
        return alu_row_plain(cfg, row, regs)
    fields = check_alu_row_args(cfg, row, regs)
    if regs.shape[0]:
        build.launch("egpu_alu_row", "alu", regs.device, *fields,
                     cfg.n_threads, regs.data_ptr(), regs.shape[0])
    return regs
