"""Card time a step of the operations launched inside the port's
``optim.adamw`` span: the update of every parameter and both moments
(traced sub-window)."""
from harness import program_spans

program_spans.install()


def read(run):
    return program_spans.card_ms(run, {"optim.adamw"})
