"""Training loop: checkpoint/restart, straggler watchdog, metrics log.

Fault-tolerance contract:
  * the loop can be killed at ANY step and resumed with the same command —
    it restores the latest complete checkpoint (params, optimizer moments,
    step counter, data-pipeline position) and continues bit-identically to
    a run that never died (deterministic pipeline + step-indexed batches);
  * saves are atomic and (optionally) async;
  * the watchdog records per-step wall times and flags stragglers at
    k * MAD above the running median — on a real multi-host cluster this is
    the signal for preempt/redispatch; here it is measured, logged, and
    surfaced in metrics so the policy layer is testable.

The model handed to a resumed run may hold weights a crashed run updated:
the restore overwrites every parameter in place, and the moments and the
step counter, so the step reads nothing of the crashed run.

On a mesh (``mesh=``, every rank of the world runs the loop) the state is
placed by the sharding rules, the step is ``make_sharded_train_step``,
checkpoints hold the global tensors (rank 0 writes them) and a resume
restores straight onto the mesh.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable

import numpy as np
import torch

from ..checkpoint import ckpt
from ..configs.base import ModelConfig, RunConfig
from ..data.pipeline import PipelineSpec, make_batch
from .step import (
    TrainState,
    init_state,
    make_sharded_train_step,
    make_train_step,
)


class Watchdog:
    """Per-step wall-time tracker with MAD-based straggler detection."""

    def __init__(self, window: int = 50, k: float = 5.0):
        self.times: list[float] = []
        self.window = window
        self.k = k
        self.flagged: list[int] = []

    def record(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        hist = np.asarray(self.times[-self.window:])
        if len(hist) < 8:
            return False
        med = float(np.median(hist))
        mad = float(np.median(np.abs(hist - med))) + 1e-9
        is_straggler = dt > med + self.k * 1.4826 * mad and dt > 1.5 * med
        if is_straggler:
            self.flagged.append(step)
        return is_straggler


@dataclasses.dataclass
class LoopResult:
    state: TrainState
    losses: list
    straggler_steps: list
    resumed_from: int


def _resume(state: TrainState, ckpt_dir: str, step: int, shardings=None):
    """``state`` at the checkpoint of ``step``: its parameters overwritten
    in place (they are the model's), its moments and counter replaced; on
    a mesh (``shardings``) the whole state restored onto it."""
    saved, extra = ckpt.restore(ckpt_dir, state, step=step,
                                shardings=shardings)
    if shardings is not None:
        return saved, extra
    with torch.no_grad():
        for k, p in state.params.items():
            p.copy_(saved.params[k])
    return saved._replace(params=state.params), extra


def train_loop(model, cfg: ModelConfig, rc: RunConfig, spec: PipelineSpec,
               n_steps: int, *, state: TrainState | None = None,
               step_fn: Callable | None = None,
               log_path: str | None = None,
               fail_at_step: int | None = None, mesh=None) -> LoopResult:
    """Run (or resume) training for up to ``n_steps`` total steps, on the
    device of ``model``'s weights (on ``mesh``'s ranks if given).

    ``fail_at_step`` injects a crash (for the restart tests — the paper of
    record for "would it survive node failure" is a test, not a promise).
    """
    if step_fn is None:
        step_fn = make_train_step(model, rc, n_steps) if mesh is None \
            else make_sharded_train_step(model, rc, mesh, n_steps)
    saver = ckpt.AsyncSaver() if rc.async_ckpt else None
    os.makedirs(rc.ckpt_dir, exist_ok=True)
    resumed_from = 0

    if state is None:
        state = init_state(model, rc)
        shardings = None
        if mesh is not None:
            from ..launch.shardings import place, state_shardings

            shardings = state_shardings(mesh, state, model.cfg)
            state = place(state, shardings)
        latest = ckpt.latest_step(rc.ckpt_dir)
        if latest is not None:
            state, extra = _resume(state, rc.ckpt_dir, latest, shardings)
            resumed_from = int(extra.get("step", latest))

    device = next(iter(state.params.values())).device
    wd = Watchdog()
    losses = []
    logf = open(log_path, "a") if log_path else None
    start_step = int(state.step)
    try:
        for step in range(start_step, n_steps):
            if fail_at_step is not None and step == fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            t0 = time.perf_counter()
            batch = make_batch(cfg, spec, step, device=device)
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            straggle = wd.record(step, dt)
            losses.append(loss)
            if logf:
                logf.write(json.dumps({"step": step, "loss": loss, "dt": dt,
                                       "straggler": straggle}) + "\n")
                if step % 10 == 0:
                    logf.flush()
            if rc.ckpt_every and (step + 1) % rc.ckpt_every == 0:
                extra = {"step": step + 1, "pipeline_step": step + 1,
                         "seed": rc.seed}
                if saver:
                    saver.save(rc.ckpt_dir, step + 1, state, extra)
                else:
                    ckpt.save(rc.ckpt_dir, step + 1, state, extra)
    finally:
        # a save in flight completes (or raises) before the loop ends, a
        # failed run's too
        if saver:
            saver.wait()
        if logf:
            logf.close()
    return LoopResult(state=state, losses=losses,
                      straggler_steps=wd.flagged, resumed_from=resumed_from)
