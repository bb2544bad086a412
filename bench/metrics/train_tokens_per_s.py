"""Training tokens a second: every token of every step the window
completed, over the window's seconds (host clock; each step ends when its
loss is read)."""


def read(run):
    if not run.tokens:
        return None
    return run.tokens / run.window_s
