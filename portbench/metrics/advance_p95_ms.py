"""95th percentile of the latency of every advance in the window, ms."""
from portbench.stats import percentile


def read(run):
    if run.unit != "advance" or not run.latencies_s:
        return None
    return 1e3 * percentile(run.latencies_s, 95)
