"""Fixpoint rounds a serving advance ran, over every group's solve (the
port's ``fixpoint.rounds`` counter of ``repro_torch.obs``: one a loop body
of ``FixpointRunner.run`` / ``run_with_metrics``, the ladder and PageRank's
iterations), summed over the traced window's advances and divided by their
count.  The counters record only under the profiler, so the last
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
    return sum(s.counts.get("fixpoint.rounds", 0) for s in roots[-n:]) / n
