"""Card time a step of the operations launched inside the port's
``embed`` and ``head`` spans, forward and backward: the table's gather
and its scatter back, the final norm, the unembedding and the
cross-entropy (traced sub-window)."""
from harness import program_spans

program_spans.install()


def read(run):
    return program_spans.card_ms(run, {"embed", "head"})
