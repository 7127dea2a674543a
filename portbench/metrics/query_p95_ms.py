"""95th percentile of the latency of every query in the window, ms."""
from portbench.stats import percentile


def read(run):
    if run.unit != "query" or not run.latencies_s:
        return None
    return 1e3 * percentile(run.latencies_s, 95)
