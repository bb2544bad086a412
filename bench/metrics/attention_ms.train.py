"""Card time a step of the operations launched inside the port's ``attn``
spans, forward and backward: the norm, the projections, RoPE, the S^2
scores and the residual add of every layer (traced sub-window)."""
from harness import program_spans

program_spans.install()


def read(run):
    return program_spans.card_ms(run, {"attn"})
