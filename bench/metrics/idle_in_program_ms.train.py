"""Card-idle ms a step that the port's own host code causes: each idle
gap of the traced sub-window whose ending operation was launched inside
a port span, summed over those gaps (the card waits there on the
program's next launch)."""
from harness import program_spans

program_spans.install()


def read(run):
    by_span = program_spans.idle_by_span(run)
    if by_span is None:
        return None
    return 1e3 * sum(by_span.values()) / run.counters["profile_steps"]
