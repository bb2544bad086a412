"""Faults planted in the program under a run, for the tests and the
calibration that show the output check fails them: each is a hook that
takes the run's program object (``train.Program``) before its first
step."""
from __future__ import annotations


def frozen_step(prog) -> None:
    """The training step computes its loss and returns its state
    unchanged."""
    model = prog.model

    def step(state, batch):
        loss, _ = model.loss(batch)
        return state, {"loss": loss.detach()}
    prog.step_fn = step


def half_batch(prog) -> None:
    """The loss leaves out half of the batch's rows and takes the mean
    over the rest."""
    model = prog.model
    loss = model.loss
    model.loss = lambda batch: loss(
        {k: v[: v.shape[0] // 2] for k, v in batch.items()})


FAULTS = {"frozen_step": frozen_step, "half_batch": half_batch}
