"""The training step's share of the card's float32 peak: the model FLOPs
of a step (6 N D, N every parameter, D the step's tokens) over the
window's mean step time and the peak (67e12 FLOP/s, no tensor cores)."""
from harness import flops


def read(run):
    if not run.tokens:
        return None
    f = flops.train_flops(run.cell.model, run.tokens)
    return 100.0 * f / (run.window_s * flops.PEAK_FLOPS_FP32)
