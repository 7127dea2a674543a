"""Serving advances completed in the window over the window's seconds."""


def read(run):
    return len(run.latencies_s) / run.window_s if run.unit == "advance" else None
