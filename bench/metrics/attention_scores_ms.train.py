"""Card time a step of the operations launched inside the port's
``attn.scores`` spans, forward and backward: the float32 S^2 scores, the
causal mask, the softmax and the weighted sum (traced sub-window)."""
from harness import program_spans

program_spans.install()


def read(run):
    return program_spans.card_ms(run, {"attn.scores"})
