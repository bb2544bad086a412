"""Card time a step of the operations launched inside the benchmark's
spans around ``clip_by_global_norm`` and ``adamw.apply`` (traced
sub-window)."""


def read(run):
    p = run.profile
    if p is None or not p.has_device:
        return None
    ops = list(p.launched_in("optimizer"))
    if not ops:
        return None
    return 1e3 * p.device_s(ops) / run.counters["profile_steps"]
