"""Device extent of a distributed EA round, ms: the mean over the traced
window's ``fixpoint.round`` spans of the port's ``repro_torch.obs`` (a pair
of CUDA events on the stream around each round of ``run_distributed_ea``:
the relax, the convergence test and the idle the host left inside them).
The spans record only under the profiler, so the last ``queries``
``ea.query`` roots are the traced window's.  Nothing from a port without
spans."""


def read(run):
    n = int(run.traced_counts.get("queries", 0))
    try:
        from repro_torch import obs
    except ImportError:
        return None
    spans = obs.records().spans
    roots = [s for s in spans if s.parent < 0 and s.name == "ea.query"]
    if not n or len(roots) < n:
        return None
    ids = {s.request for s in roots[-n:]}
    ms = [s.device_ms for s in spans if s.request in ids and s.name == "fixpoint.round"
          and s.device_ms is not None]
    return sum(ms) / len(ms) if ms else None
