"""1 - (union of the device's kernel, copy and fill intervals) / (the
traced window's wall time), from torch.profiler, %.  Nothing without a
device interval in the trace (a run on the CPU)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
