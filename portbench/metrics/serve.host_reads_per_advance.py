"""Reads of a device value on the host in a serving advance (the port's
``host_reads`` counter of ``repro_torch.obs``: each loop condition's
``bool``, the ladder's measures, a sharded solve's round count), each one
draining the queue, summed over the traced window's advances and divided by
their count.  The counters record only under the profiler, so the last
``advances`` ``serve.advance`` roots are the traced window's.  Nothing from
a port without counters."""


def read(run):
    n = int(run.traced_counts.get("advances", 0))
    try:
        from repro_torch import obs
    except ImportError:
        return None
    roots = [s for s in obs.records().spans if s.parent < 0 and s.name == "serve.advance"]
    if not n or len(roots) < n:
        return None
    return sum(s.counts.get("host_reads", 0) for s in roots[-n:]) / n
