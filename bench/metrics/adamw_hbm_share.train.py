"""AdamW's share of the card's memory bandwidth: the bytes the port
counts for its updates (``optim.adamw``'s ``bytes``: each parameter read
and written, its gradient read, both moments read and written) over the
card time of what those spans launched, at 3.35e12 B/s (H100 SXM data
sheet; traced sub-window)."""
from harness import program_spans

PEAK_BYTES_S = 3.35e12

program_spans.install()


def read(run):
    spans = program_spans.spans_of(run)
    if spans is None:
        return None
    mine = [(a, b, r) for a, b, r in spans if r.name == "optim.adamw"]
    if not mine:
        return None
    ops = program_spans.launched_in(run.profile, mine, {"optim.adamw"})
    card_s = run.profile.device_s(ops)
    if not card_s:
        return None
    moved = sum(r.counts["bytes"] for *_, r in mine)
    return 100.0 * moved / (card_s * PEAK_BYTES_S)
