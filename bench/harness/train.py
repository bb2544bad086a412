"""A training cell: the port's step (``train.step.make_train_step``:
forward, loss, backward, clip, AdamW) on the benchmark's weights and
batches.

Set-up builds the model and its optimizer state once and drives that
state through the cell's first ``check_steps`` steps with the window's own
call and feed; what the reference follows is read from them: each step's
loss, each leaf's gradient as AdamW got it (its first moment after one
step over ``1 - beta1``) and each leaf's change over those steps (the
weights against the seed's). The window then runs steps on the same
state until ``--seconds`` have passed, each ended by reading its loss.
"""
from __future__ import annotations

import gc
import math
import statistics
import time

import torch

from . import program, weights
from .trace import Spans, profiled
from .traffic import TrainFeed


def _hp(traffic: dict) -> dict:
    return dict(traffic["optimizer"])


def change_norms(model: dict, seed: int, device, params) -> dict:
    """Each leaf's distance from the seed's weights, made again one group
    at a time."""
    out = {}
    with torch.no_grad():
        for i, (_, leaves) in enumerate(weights.groups(model)):
            for name, w0 in weights.make_group(leaves, seed, i,
                                               device).items():
                out[name] = float(torch.linalg.vector_norm(
                    params[name].detach() - w0))
    return out


class Program:
    """The port's training state and step, and what its first steps
    read."""

    def __init__(self, run, tokens_per_step: int):
        from repro_torch.configs.base import RunConfig
        from repro_torch.train import step as train_step
        run.mark("import the program")

        cell = run.cell
        hp = _hp(cell.traffic)
        self.rc = RunConfig(
            learning_rate=hp["learning_rate"], warmup_steps=hp["warmup_steps"],
            weight_decay=hp["weight_decay"], beta1=hp["beta1"],
            beta2=hp["beta2"], grad_clip=hp["grad_clip"],
            microbatch=int(cell.traffic.get("microbatch", 0)))
        leaves = weights.make_all(cell.model, run.seed, run.device)
        run.mark("weights")
        self.model = program.build_lm(cell.model, leaves, train=True)
        self.state = train_step.init_state(self.model, self.rc)
        self.step_fn = train_step.make_train_step(
            self.model, self.rc, total_steps=hp["total_steps"])
        self.feed = TrainFeed(cell.traffic, cell.model, run.seed, run.device)
        self.tokens_per_step = tokens_per_step
        self.i = 0

    def step(self) -> float:
        self.state, m = self.step_fn(self.state, self.feed.batch(self.i))
        self.i += 1
        return float(m["loss"])

    def first_steps(self, run, n: int) -> dict:
        losses, grads = [], None
        for i in range(n):
            losses.append(self.step())
            run.mark(f"step {i}")
            if grads is None:
                grads = {k: float(torch.linalg.vector_norm(mu))
                         / (1 - self.rc.beta1)
                         for k, mu in self.state.opt.mu.items()}
        change = change_norms(run.cell.model, run.seed, run.device,
                              self.state.params)
        run.mark("change norms")
        return {"losses": losses, "grads": grads, "change": change}


def reference(run, tf32: bool = False) -> dict:
    """The plain reference over the same first steps, from the seed."""
    from reference import lm

    cell = run.cell
    n = int(cell.traffic["check_steps"])
    feed = TrainFeed(cell.traffic, cell.model, run.seed, run.device)
    batches = [feed.batch(i)["tokens"] for i in range(n)]
    hp = _hp(cell.traffic)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        w = weights.make_all(cell.model, run.seed, run.device)
        losses, grads = lm.train_steps(w, batches, cell.model, hp,
                                       rows=int(cell.traffic.get(
                                           "reference_rows", 0)))
        change = change_norms(cell.model, run.seed, run.device, w)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    return {"losses": losses, "grads": grads, "change": change}


def compare(got: dict, ref: dict) -> dict:
    """The numbers the limits hold: the widest relative gap of a step's
    loss; of a leaf's gradient norm and of its change's norm, each
    against the larger of that leaf's reference norm and the median
    leaf's. Leaves whose reference gradient is under a thousandth of the
    median leaf's move by round-off alone and are left out of the
    change."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                    ref["losses"]))
    g_med = statistics.median(ref["grads"].values())
    grad = max(abs(got["grads"][k] - r) / max(r, g_med)
               for k, r in ref["grads"].items())
    moved = [k for k, r in ref["grads"].items() if r >= 1e-3 * g_med]
    c_med = statistics.median(ref["change"][k] for k in moved)
    change = max(abs(got["change"][k] - ref["change"][k])
                 / max(ref["change"][k], c_med) for k in moved)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def drive(run, t0: float, hooks=None) -> None:
    """One run of the cell into ``run``; ``hooks`` plants a fault in the
    program (tests and the calibration only)."""
    cell, dev = run.cell, run.device
    B, S = int(cell.traffic["batch"]), int(cell.traffic["seq_len"])
    prog = Program(run, B * S)
    run.mark("model, state")
    if hooks:
        hooks(prog)
    got = prog.first_steps(run, int(cell.traffic["check_steps"]))
    if dev != "cpu":
        torch.cuda.synchronize()
    # set-up's objects out of the collector's way in the window
    gc.collect()
    gc.freeze()
    run.setup_s = time.perf_counter() - t0

    run.t_start = time.perf_counter()
    while True:
        a = time.perf_counter()
        loss = prog.step()
        b = time.perf_counter()
        run.steps.append((a, b))
        run.attempted += 1
        run.failed += not math.isfinite(loss)
        if b - run.t_start >= run.seconds:
            break
    run.t_end = b
    gc.unfreeze()
    run.tokens = len(run.steps) * prog.tokens_per_step
    if dev != "cpu":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()

    if run.trace:
        _traced(run, prog)
    del prog
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()
    ref = reference(run)
    for name, v in compare(got, ref).items():
        run.checks[name] = (v, float(cell.limits[name]))


def _traced(run, prog) -> None:
    """A short profiled sub-window of the same steps, with host spans
    around the step, the clip and the AdamW update."""
    from repro_torch.optim import adamw, clip

    spans = Spans()
    out = []
    with program.patched(clip, "clip_by_global_norm",
                         lambda f: program.in_span(spans, "optimizer", f)), \
            program.patched(adamw, "apply",
                            lambda f: program.in_span(spans, "optimizer", f)):
        n = int(run.cell.traffic.get("profile_steps", 2))
        with profiled(run.cell.name, spans, out):
            for _ in range(n):
                with spans("step"):
                    prog.state, m = prog.step_fn(prog.state,
                                                 prog.feed.batch(prog.i))
                prog.i += 1
                with spans("bookkeeping"):
                    float(m["loss"])
    run.profile = out[0]
    run.counters["profile_steps"] = n
