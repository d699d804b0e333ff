"""Every token the window generated, over all rows, divided by the window's
wall time (host clock; round restores included)."""


def read(run):
    return run.window_steps * run.batch / run.window_s
