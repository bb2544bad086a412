"""Card time a step of the operations launched inside the port's ``ffn``
spans, forward and backward: the norm, the SwiGLU MLP and the residual
add of every layer (traced sub-window)."""
from harness import program_spans

program_spans.install()


def read(run):
    return program_spans.card_ms(run, {"ffn"})
