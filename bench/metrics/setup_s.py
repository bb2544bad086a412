"""Set-up: from the start of the process to the first timed step
(weights drawn, the model built, the shapes warmed up; host clock)."""


def read(run):
    return run.setup_s
