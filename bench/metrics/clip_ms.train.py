"""Card time a step of the operations launched inside the port's
``optim.clip`` span: the global norm and the scaling of every gradient
(traced sub-window)."""
from harness import program_spans

program_spans.install()


def read(run):
    return program_spans.card_ms(run, {"optim.clip"})
