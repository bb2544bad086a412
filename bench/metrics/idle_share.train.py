"""The share of the traced sub-window in which no operation ran on the
card (training steps)."""


def read(run):
    p = run.profile
    return p.idle_share() if p is not None and p.has_device else None
